"""The port's import of reference (TensorFlow) checkpoints
(``nspeech_tpu_torch/migrate``, ``cli.import_reference_ckpt``) against the
JAX package's, on the CPU.

- The port's bundle reader against the JAX package's and against
  ``tf.train.load_checkpoint``, on bundles that TensorFlow writes
  (``SaveV2``): every array bit for bit with the same dtype, over mixed
  dtypes and over reference-named WaveNet and Tacotron-2 bundles.
- Corruption (a flipped payload byte, a flipped index-block byte, a
  truncated index, a lost magic, a missing shard): the same
  ``BundleError`` message as the JAX package's reader.
- crc32c and snappy against the spec vectors and the JAX package's copy.
- The mappers on the JAX package's synthetic name sets
  (``tests/test_tf_import.py``, ``tests/test_tf_import_taco.py``):
  trees equal leaf for leaf (``np.array_equal``) and the same derived
  hparams, optimizer slots and a different wrapper nesting included; the
  same refusals with the same messages. ``detect_model`` closes the
  reader it opens.
- The CLI end to end: a Tacotron-2 and a WaveNet bundle written by
  TensorFlow go through ``cli.import_reference_ckpt --device cpu``;
  ``cli.synthesize`` serves the imported Tacotron-2, and the port's
  ``Synthesizer`` serves it within the
  pipeline tests' 1e-4 of the JAX package serving its own import
  (``import_reference_ckpt.py``), and the imported WaveNet's
  teacher-forced logits equal JAX's on its own import within 1e-5.

The cases that need TensorFlow skip without it, as the JAX package's
(``needs_tf``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import import_reference_ckpt as jax_cli
from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.migrate import (BundleError as JBundleError,
                                 ImportError_ as JImportError,
                                 TFBundleReader as JReader,
                                 check_dilations as j_check_dilations,
                                 import_wavenet as j_import_wavenet)
from nspeech_tpu.migrate import tfbundle as jb
from nspeech_tpu.migrate.tacotron import (detect_model as j_detect,
                                          import_tacotron as j_import_tacotron)
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.serving import Synthesizer as JSynth
from nspeech_tpu_torch.cli import import_reference_ckpt as port_cli
from nspeech_tpu_torch.cli import synthesize as synth_cli
from nspeech_tpu_torch.dsp.wavio import load_wav
from nspeech_tpu_torch.migrate import (BundleError, ImportError_, TFBundleReader,
                                       check_dilations, detect_model,
                                       import_tacotron, import_wavenet)
from nspeech_tpu_torch.migrate import tfbundle as pb
from nspeech_tpu_torch.models import WaveNet
from nspeech_tpu_torch.models import create_model as t_create
from nspeech_tpu_torch.serving import Synthesizer
from nspeech_tpu_torch.train import config_from_checkpoint, load_serving_params

from tests.make_reference_ckpt import taco2_names, wavenet_names, write_bundle
from tests.test_tf_import import _synthetic_ref_tensors
from tests.test_tf_import_taco import _synthetic_taco2

try:
    import tensorflow as tf
except ImportError:
    tf = None

needs_tf = pytest.mark.skipif(tf is None, reason="tensorflow not installed")

torch.set_num_threads(1)

TACO = ("encoder_conv_layers=1,postnet_conv_layers=1,expand_conv_layers=1,"
        "encoder_conv_channels=16,attention_dim=16,postnet_conv_channels=16,"
        "expand_conv_channels=16,decoder_lstm_units=16,encoder_lstm_units=8,"
        "expand_lstm_units=8,embedding_dim=16")
SERVE = "max_iters=4,griffin_lim_iters=2"
WAVENET = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
           "dilation_channels=8,skip_channels=16,quantization_channels=64,"
           "lc_channels=5,gc_channels=4,gc_category_cardinality=3,"
           "use_biases=True")


def flatten(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in
                flatten(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, item in enumerate(tree) for k, v in
                flatten(item, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def assert_trees_equal(got, want):
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def jax_taco2():
    cfg = j_load("taco2").parse(TACO)
    params, state = j_create("taco2", cfg).init(jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


def jax_wavenet():
    cfg = j_load("wavenet").parse(WAVENET)
    net = j_create("wavenet", cfg)
    return cfg, net, jax.tree_util.tree_map(np.asarray,
                                            net.init(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """TensorFlow-written bundles: {kind: prefix}."""
    if tf is None:
        pytest.skip("tensorflow not installed")
    d = tmp_path_factory.mktemp("bundles")
    rng = np.random.default_rng(0)
    mixed = {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(5),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
        "i64": rng.integers(-2 ** 40, 2 ** 40, (2, 3)),
        "i8": rng.integers(-100, 100, (6,)).astype(np.int8),
        "u8": rng.integers(0, 255, (6,)).astype(np.uint8),
        "flag": np.array([True, False, True]),
        "scalar/step": np.array(777, np.int64),
    }
    params, state = jax_taco2()
    return {
        "mixed": write_bundle(str(d / "mixed.ckpt"), mixed),
        "taco2": write_bundle(str(d / "taco2.ckpt-1234"),
                              taco2_names(params, state)),
        "wavenet": write_bundle(str(d / "wavenet.ckpt-555"),
                                wavenet_names(jax_wavenet()[2])),
    }


@needs_tf
@pytest.mark.parametrize("kind", ["mixed", "taco2", "wavenet"])
def test_reader_matches_tf_and_jax(bundles, kind):
    prefix = bundles[kind]
    ours, theirs = TFBundleReader(prefix), JReader(prefix)
    ck = tf.train.load_checkpoint(prefix)
    names = ours.variable_names()
    assert names == theirs.variable_names()
    assert sorted(ck.get_variable_to_shape_map()) == names
    for name in names:
        mine = ours.get_tensor(name)
        for other in (theirs.get_tensor(name), ck.get_tensor(name)):
            other = np.asarray(other)
            assert mine.dtype == other.dtype and mine.shape == other.shape, name
            assert mine.tobytes() == other.tobytes(), name
        assert ours.shape(name) == tuple(mine.shape)


def corrupt(prefix, kind, tmp_path):
    """A damaged copy of the bundle at ``prefix``; returns its prefix."""
    index = bytearray(Path(prefix + ".index").read_bytes())
    data = bytearray(Path(prefix + ".data-00000-of-00001").read_bytes())
    if kind == "payload":
        data[TFBundleReader(prefix)._entry("wavenet/causal_layer/filter").offset] ^= 0xFF
    elif kind == "index_block":
        index[5] ^= 0xFF
    elif kind == "truncated":
        index = index[:20]
    elif kind == "magic":
        index[-8:] = b"\x00" * 8
    out = str(tmp_path / f"{kind}.ckpt")
    Path(out + ".index").write_bytes(bytes(index))
    if kind != "missing_shard":
        Path(out + ".data-00000-of-00001").write_bytes(bytes(data))
    return out


@needs_tf
@pytest.mark.parametrize("kind", ["payload", "index_block", "truncated", "magic",
                                  "missing_shard"])
def test_reader_rejects_corruption_as_jax(bundles, tmp_path, kind):
    prefix = corrupt(bundles["wavenet"], kind, tmp_path)
    errors = []
    for reader in (TFBundleReader, JReader):
        with pytest.raises(ValueError) as e:
            r = reader(prefix)
            for name in r.variable_names():
                r.get_tensor(name)
        errors.append(e.value)
    assert isinstance(errors[0], BundleError)
    assert isinstance(errors[1], JBundleError)
    assert str(errors[0]) == str(errors[1])


def test_crc32c_and_snappy_spec_vectors():
    assert pb.crc32c(b"123456789") == 0xE3069283      # Castagnoli's vector
    crc = 0xE3069283
    assert pb.masked_crc32c(b"123456789") == (
        (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)
    blob = np.random.default_rng(1).bytes(4099)
    assert pb.crc32c(blob) == jb.crc32c(blob)
    assert pb.masked_crc32c(blob) == jb.masked_crc32c(blob)
    # a literal "abab", then a copy of offset 2 and length 6 that overlaps it
    comp = bytes([10, (4 - 1) << 2, ord("a"), ord("b"), ord("a"), ord("b"),
                  ((6 - 4) << 2) | 1, 2])
    assert pb.snappy_decompress(comp) == b"ababababab" == jb.snappy_decompress(comp)
    prefix = bytes([10, (2 - 1) << 2, ord("a"), ord("b")])
    for bad, match in ((bytes([4, ((6 - 4) << 2) | 1, 9]), None),
                       (prefix + bytes([(3 - 1) << 2 | 2, 2]), "truncated"),
                       (prefix + bytes([(3 - 1) << 2 | 3, 2, 0]), "truncated"),
                       (prefix + bytes([((6 - 4) << 2) | 1]), "truncated")):
        with pytest.raises(BundleError, match=match) as ours:
            pb.snappy_decompress(bad)
        with pytest.raises(JBundleError) as theirs:
            jb.snappy_decompress(bad)
        assert str(ours.value) == str(theirs.value)


def wavenet_set(kind):
    rng = np.random.default_rng(7)
    if kind == "stock":
        return _synthetic_ref_tensors(rng)
    if kind == "gc":
        return _synthetic_ref_tensors(rng, gc_ch=4, biases=True)
    t = _synthetic_ref_tensors(rng, lc_ch=5, biases=True)
    t["wavenet/causal_layer/filter/Adam"] = np.zeros((2, 16, 4))
    t["wavenet/causal_layer/filter/Adam_1"] = np.zeros((2, 16, 4))
    t["beta1_power"] = np.zeros(())
    return t


@pytest.mark.parametrize("kind", ["stock", "gc", "lc_biases_adam"])
def test_wavenet_mapping_matches_jax(kind):
    params, derived = import_wavenet(wavenet_set(kind))
    j_params, j_derived = j_import_wavenet(wavenet_set(kind))
    assert derived == j_derived
    assert_trees_equal(params, j_params)


def taco2_set(kind):
    rng = np.random.default_rng(8)
    if kind == "drift":
        return _synthetic_taco2(rng, nest="while/attention_decoder_1")
    t = _synthetic_taco2(rng)
    if kind == "adam":
        t["model/inference/encoder/conv_0/conv1d/kernel/Adam"] = np.zeros((2,))
        t["model/optimizer/beta1_power"] = np.zeros(())
        t["global_step"] = np.zeros(())
    return t


@pytest.mark.parametrize("kind", ["stock", "drift", "adam"])
def test_taco2_mapping_matches_jax(kind):
    params, state, hp = import_tacotron(taco2_set(kind), "taco2")
    j_params, j_state, j_hp = j_import_tacotron(taco2_set(kind), "taco2")
    assert hp == j_hp
    assert_trees_equal(params, j_params)
    assert_trees_equal(state, j_state)
    assert detect_model(taco2_set(kind)) == j_detect(taco2_set(kind)) == "taco2"
    if kind == "drift":       # the wrapper nesting does not move a leaf
        assert_trees_equal(params, import_tacotron(taco2_set("stock"), "taco2")[0])


def _missing_gate():
    t = wavenet_set("stock")
    del t["wavenet/dilated_stack/layer1/gate"]
    return t


def _with(t, name):
    t = dict(t)
    t[name] = np.zeros((3,))
    return t


REFUSALS = {
    "not_wavenet": lambda m: m["import_wavenet"]({"model/w": np.zeros((3, 3))}),
    "missing_gate": lambda m: m["import_wavenet"](_missing_gate()),
    "unrecognized": lambda m: m["import_wavenet"](
        _with(wavenet_set("stock"), "wavenet/dilated_stack/layer0/mystery")),
    "not_tacotron": lambda m: m["import_tacotron"]({"foo/bar": np.zeros((2,))},
                                                   "taco2"),
    "unmapped": lambda m: m["import_tacotron"](
        _with(taco2_set("stock"), "model/inference/encoder/mystery"), "taco2"),
    "undetectable": lambda m: m["detect_model"]({"model/other/w": np.zeros((2,))}),
    "dilations": lambda m: m["check_dilations"](6, 4, 2),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    ours = {"import_wavenet": import_wavenet, "import_tacotron": import_tacotron,
            "detect_model": detect_model, "check_dilations": check_dilations}
    theirs = {"import_wavenet": j_import_wavenet,
              "import_tacotron": j_import_tacotron,
              "detect_model": j_detect, "check_dilations": j_check_dilations}
    with pytest.raises(ImportError_) as got:
        REFUSALS[case](ours)
    with pytest.raises(JImportError) as want:
        REFUSALS[case](theirs)
    assert str(got.value) == str(want.value)


@needs_tf
def test_detect_model_closes_its_reader(bundles, monkeypatch):
    closed = []
    real = TFBundleReader.close
    monkeypatch.setattr(TFBundleReader, "close",
                        lambda self: closed.append(self) or real(self))
    assert detect_model(bundles["taco2"]) == j_detect(bundles["taco2"]) == "taco2"
    assert detect_model(bundles["wavenet"]) == "wavenet"
    assert len(closed) == 2
    reader = TFBundleReader(bundles["taco2"])   # a caller's reader stays open
    assert detect_model(reader) == "taco2" and len(closed) == 2


@needs_tf
def test_cli_imports_taco2_and_serves_as_jax(bundles, tmp_path, capsys):
    prefix = bundles["taco2"]
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_cli.main(["--ckpt", prefix + ".index", "--out", ours,
                          "--hparams", SERVE, "--device", "cpu"]) == 0
    assert "Detected reference model: taco2" in capsys.readouterr().out
    assert jax_cli.main(["--ckpt", prefix, "--out", theirs,
                         "--hparams", SERVE]) == 0
    cfg, name = config_from_checkpoint(ours + "/ckpt")
    assert name == "taco2" and int(cfg.max_iters) == 4
    params, state, _ = j_import_tacotron(prefix, "taco2")
    served, served_state = load_serving_params(
        ours + "/ckpt", t_create("taco2", cfg), step=1234)
    assert_trees_equal(served, params)
    assert_trees_equal(served_state, state)
    text = "imported weights speak"
    tw, tm, tl = Synthesizer.from_checkpoint(ours + "/ckpt", device="cpu",
                                             text_bucket=16).synthesize(text)
    jw, jm, jl = JSynth.from_checkpoint(theirs + "/ckpt",
                                        text_bucket=16).synthesize(text)
    assert tm.shape == np.asarray(jm).shape
    np.testing.assert_allclose(tm, np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-4)
    wav = str(tmp_path / "imported.wav")
    synth_cli.main(["--device", "cpu", "--checkpoint", ours + "/ckpt",
                    "--text", text, "--out", wav])
    assert load_wav(wav, int(cfg.sample_rate)).size > 0


@needs_tf
def test_cli_imports_wavenet_logits_match_jax(bundles, tmp_path):
    prefix = bundles["wavenet"]
    out = str(tmp_path / "port")
    assert port_cli.main(["--ckpt", prefix, "--out", out, "--device", "cpu",
                          "--dilations-length", "3",
                          "--dilations-depth", "2"]) == 0
    cfg, name = config_from_checkpoint(out + "/ckpt")
    assert name == "wavenet" and int(cfg.num_speakers) == 3
    net = WaveNet(cfg)
    params, _ = load_serving_params(out + "/ckpt", net, step=555)
    j_cfg, j_net, _ = jax_wavenet()
    j_params, _ = j_import_wavenet(prefix)
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 64, (2, 40))
    gc = np.array([1, 2])
    lc = rng.standard_normal((2, 40, 5)).astype(np.float32)
    want = np.asarray(j_net.predict_logits(j_params, jnp.asarray(codes),
                                           jnp.asarray(gc), jnp.asarray(lc)))
    got = net.predict_logits(params, torch.from_numpy(codes),
                             torch.from_numpy(gc), torch.from_numpy(lc))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ImportError_, match="cannot be recovered"):
        port_cli.main(["--ckpt", prefix, "--out", str(tmp_path / "bad"),
                       "--device", "cpu", "--dilations-length", "4"])
