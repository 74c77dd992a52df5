"""Serving export (``nspeech_tpu_torch/serving/export.py``) on the CPU, at
tiny widths: the traceable decode against the chunked one, the artifacts
against the live port and against the JAX package's artifacts.

- The ``while_loop`` decode equals ``scan_autoregressive`` bit for bit
  (outputs, alignments, steps), with a padding row and with a stop
  threshold at which the rows stop at different steps.
- A synthesizer artifact's mel and linear equal the live ``Synthesizer``'s
  bit for bit; its waveform is within 1e-4 with the same endpoint (as
  JAX's ``test_export_round_trip_exact``). Against JAX's artifact of the
  same (bridged) weights: mel and linear within 1e-4, waveform within 1e-4
  of its peak, the same length (``tests/test_torch_pipeline.py``'s bounds).
- A vocoder artifact's waveform equals the live ``WaveNetVocoder``'s at
  temperature 0 and, for one seed, at temperature 1 (the same Philox
  stream), and JAX's artifact's within 1e-5 at temperature 0.
- The loader imports no model code; the CLI and the demo server serve
  artifacts.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.serving import Synthesizer as JSynth
from nspeech_tpu.serving import WaveNetVocoder as JVoc
from nspeech_tpu.serving import export as jexport
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import WaveNet, create_model
from nspeech_tpu_torch.models import decoder as D
from nspeech_tpu_torch.ops.cuda import wavenet_op
from nspeech_tpu_torch.serving import (ClientError, ExportedSynthesizer,
                                       ExportedVocoder, Synthesizer,
                                       WaveNetVocoder)
from nspeech_tpu_torch.serving.export import (META_FILE, MODULE_FILE,
                                              VOC_META_FILE, export_synthesizer,
                                              export_vocoder)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "hello world"
TACO2 = ("max_iters=4,encoder_conv_layers=1,postnet_conv_layers=1,"
         "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
         "postnet_conv_channels=16,expand_conv_channels=16,"
         "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
         "embedding_dim=16,griffin_lim_iters=2")
# the JAX package's micro config of tests/test_export.py
TACO1 = ("max_iters=3,encoder_cbhg_banks=1,post_cbhg_banks=1,"
         "attention_dim=16,decoder_dim=16,embedding_dim=16,"
         "griffin_lim_iters=2")
TACO1_LISTS = {"encoder_prenet": [16, 16], "encoder_cbhg_bank_sizes": [16],
               "post_cbhg_bank_sizes": [80]}
VOC = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
       "dilation_channels=8,skip_channels=16,quantization_channels=64,"
       "lc_channels=80,batch_size=1")
CONFIGS = {"taco1": TACO1, "taco2": TACO2}


def configs(name, extra=""):
    """(JAX config, port config) of ``name`` at its tiny widths."""
    cfgs = []
    for load in (j_load, t_load):
        cfg = load(name).parse(CONFIGS[name])
        cfg.parse(extra)
        if name == "taco1":
            for k, v in TACO1_LISTS.items():
                setattr(cfg, k, list(v))
        cfgs.append(cfg)
    return cfgs


def synths(name, extra=""):
    """JAX and port Synthesizers on the same (bridged) weights."""
    jcfg, tcfg = configs(name, extra)
    jmodel = j_create(name, jcfg)
    jp, js = jmodel.init(jax.random.PRNGKey(0))
    jsyn = JSynth(jcfg, text_bucket=16).set_variables(jp, js, model=jmodel)
    tmodel = create_model(name, tcfg)
    tp, ts = convert.tacotron_variables(
        tmodel, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    tsyn = Synthesizer(tcfg, text_bucket=16, device="cpu").set_variables(
        tp, ts, model=tmodel)
    return jsyn, tsyn


def port_synth(name, extra=""):
    """A port Synthesizer of seeded weights (no JAX side)."""
    cfg = configs(name, extra)[1]
    model = create_model(name, cfg)
    params, bn = model.init(2)
    return Synthesizer(cfg, text_bucket=16, device="cpu").set_variables(
        params, bn, model=model)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """``get(name)`` -> (JAX synthesizer, port synthesizer, the port's
    batch-1 artifact at text_len 16, that artifact loaded on the CPU),
    built once per model."""
    cache = {}

    def get(name):
        if name not in cache:
            jsyn, tsyn = synths(name)
            out = export_synthesizer(tsyn, str(tmp_path_factory.mktemp(name)),
                                     text_len=16)
            cache[name] = (jsyn, tsyn, out, ExportedSynthesizer(out, device="cpu"))
        return cache[name]

    return get


@pytest.fixture(params=["taco1", "taco2"])
def exported(request, artifacts):
    return artifacts(request.param)


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    """(A batch-2 Tacotron-2 artifact of two speakers at text_len 16, that
    artifact loaded on the CPU)."""
    out = export_synthesizer(port_synth("taco2", "num_speakers=2"),
                             str(tmp_path_factory.mktemp("batched")),
                             text_len=16, batch=2)
    return out, ExportedSynthesizer(out, device="cpu")


# -- the decode loop -----------------------------------------------------------

def decode_both(model, params, bn, ids, lengths, threshold, rates=None):
    """(chunked, while_loop) decodes of the same inputs. With ``rates``
    [N], row r's output at its k-th step is scaled by ``rates[r] ** k``
    (a counter carried beside the cell), so that its peak |output|
    decays at its own rate."""
    step_ctx, carry0 = model.attention_context(params, bn, ids, lengths)
    step = model.make_eval_step(params, step_ctx)
    if rates is not None:
        raw = step

        def step(carry, x):
            cell, k = carry
            cell, (out, align) = raw(cell, x)
            return (cell, k + 1), (out * (rates ** k)[:, None], align)

        carry0 = (carry0, torch.zeros(ids.shape[0]))
    cfg = model.cfg
    args = (step, carry0, ids.shape[0], cfg.num_mels, cfg.outputs_per_step,
            cfg.max_iters, threshold, lengths < 1)
    with torch.no_grad():
        return D.scan_autoregressive(*args), D.while_autoregressive(*args)


@pytest.mark.parametrize("name", ["taco1", "taco2"])
def test_while_decode_equals_chunked(name):
    """Rows 0 and 2 are texts, row 1 padding. At threshold 0 no row
    stops. Then the text rows' outputs decay at rates 0.3 and 0.6 per
    step, and at the least threshold (among their peak |output| per step)
    at which both stop, at different steps, the loop exits early."""
    _, cfg = configs(name, "max_iters=10")
    model = create_model(name, cfg)
    params, bn = model.init(3)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 40, (3, 12)))
    lengths = torch.tensor([12, 0, 7])
    for threshold, rates in ((0.0, None), (None, torch.tensor([0.3, 1.0, 0.6]))):
        if threshold is None:       # where the decaying rows stop
            (outs, _, _), _ = decode_both(model, params, bn, ids, lengths,
                                          0.0, rates)
            peak = outs.abs().amax(dim=-1)[:, [0, 2]]       # [S, 2]

            def stops(v):
                below = (peak <= v).int()
                return [int(below[:, r].argmax()) + 1 if below[:, r].any()
                        else cfg.max_iters for r in range(2)]

            threshold = min(float(v) for v in peak.flatten()
                            if max(stops(v)) < cfg.max_iters
                            and len(set(stops(v))) == 2)
            want = [stops(threshold)[0], 0, stops(threshold)[1]]
        else:
            want = [cfg.max_iters, 0, cfg.max_iters]
        ref, traced = decode_both(model, params, bn, ids, lengths, threshold,
                                  rates)
        for a, b in zip(ref, traced):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert ref[2].tolist() == want


# -- the synthesizer artifact --------------------------------------------------

def test_round_trip_exact(exported):
    _, tsyn, out, ex = exported
    assert os.path.exists(os.path.join(out, MODULE_FILE))
    wav0, mel0, lin0 = tsyn.synthesize(TEXT)
    wav1, mel1, lin1 = ex.synthesize(TEXT)
    np.testing.assert_array_equal(mel0, mel1)
    np.testing.assert_array_equal(lin0, lin1)
    assert len(wav0) == len(wav1) > 0
    np.testing.assert_allclose(wav0, wav1, atol=1e-4)


def test_matches_jax_artifact(exported, tmp_path):
    jsyn, _, out, ex = exported
    jout = jexport.export_synthesizer(jsyn, str(tmp_path / "jax"), text_len=16)
    jw, jm, jl = jexport.ExportedSynthesizer(jout).synthesize(TEXT)
    tw, tm, tl = ex.synthesize(TEXT)
    np.testing.assert_allclose(tm, np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-4)
    jw = np.asarray(jw, np.float32)
    assert tw.shape == jw.shape and tw.size > 0
    np.testing.assert_allclose(tw, jw, atol=1e-4 * max(np.abs(jw).max(), 1e-3))
    # export.json: JAX's fields and values (the devices listed apart)
    with open(os.path.join(jout, jexport.META_FILE)) as f:
        jmeta = json.load(f)
    with open(os.path.join(out, META_FILE)) as f:
        tmeta = json.load(f)
    assert set(jmeta) <= set(tmeta)
    assert {k: v for k, v in tmeta.items() if k in jmeta and k != "platforms"} \
        == {k: v for k, v in jmeta.items() if k != "platforms"}
    assert tmeta["platforms"] == ["cpu"] and tmeta["num_speakers"] == 1


def test_batched_artifact(batched):
    """A batch-2 artifact serves 3 texts in groups; row 0 equals the
    single-text call bit for bit."""
    ex = batched[1]
    wavs, mels, lins = ex.synthesize_batch(["first text", "second text", "third"],
                                           [0, 1, -1])
    assert len(wavs) == 3 and mels.shape[0] == 3 and lins.shape[0] == 3
    assert all(w.size and np.isfinite(w).all() for w in wavs)
    wav1, mel1, _ = ex.synthesize("first text", speaker_id=0)
    np.testing.assert_array_equal(mels[0], mel1)
    np.testing.assert_array_equal(wavs[0], wav1)


def test_rejects_bad_requests_and_devices(batched):
    """A text beyond ``text_len`` and a speaker past the table raise
    ClientError before anything runs; a device the artifact does not
    list is refused at load."""
    out, ex = batched
    with pytest.raises(ClientError, match="text_len=16"):
        ex.synthesize("this text is far longer than sixteen symbols")
    with pytest.raises(ClientError, match="speaker id 2"):
        ex.synthesize("hi", speaker_id=2)
    with pytest.raises(ValueError, match="not cuda"):
        ExportedSynthesizer(out, device="cuda")


def test_bf16_artifact_round_trip(tmp_path):
    """A synthesizer under the bf16 policy exports its bf16 program: the
    artifact's mel and linear equal the live bf16 synthesizer's."""
    tsyn = port_synth("taco2", "compute_dtype=bfloat16")
    wav0, mel0, lin0 = tsyn.synthesize(TEXT)
    out = export_synthesizer(tsyn, str(tmp_path), text_len=16)
    wav1, mel1, lin1 = ExportedSynthesizer(out, device="cpu").synthesize(TEXT)
    np.testing.assert_array_equal(mel0, mel1)
    np.testing.assert_array_equal(lin0, lin1)
    assert len(wav0) == len(wav1) and np.isfinite(wav1).all()


def test_loader_imports_no_model_code(artifacts):
    """In a fresh process, ExportedSynthesizer loads and serves with no
    module of ``nspeech_tpu_torch.models`` imported."""
    _, tsyn, out, _ = artifacts("taco2")
    _, mel, _ = tsyn.synthesize(TEXT)
    np.save(os.path.join(out, "mel.npy"), mel)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from nspeech_tpu_torch.serving import ExportedSynthesizer\n"
        f"ex = ExportedSynthesizer({out!r}, device='cpu')\n"
        f"_, mel, _ = ex.synthesize({TEXT!r})\n"
        f"assert np.array_equal(mel, np.load({os.path.join(out, 'mel.npy')!r}))\n"
        "print(sorted(m for m in sys.modules if m.startswith('nspeech_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.strip().splitlines()[-1]
    assert "nspeech_tpu_torch.serving.export" in loaded
    assert "nspeech_tpu_torch.models" not in loaded
    assert "'nspeech_tpu'" not in loaded and "'jax'" not in loaded


# -- the vocoder artifact ------------------------------------------------------

@pytest.fixture(scope="module")
def vocoders():
    """JAX and port vocoders on the same weights, and a seeded mel."""
    jcfg, tcfg = j_load("wavenet").parse(VOC), t_load("wavenet").parse(VOC)
    jnet = j_create("wavenet", jcfg)
    jparams = jnet.init(jax.random.PRNGKey(1))
    jvoc = JVoc(jcfg, use_pallas=False).set_variables(jnet, jparams)
    tnet = WaveNet(tcfg)
    tparams = convert.wavenet_params(tnet, jax.tree_util.tree_map(np.asarray, jparams))
    tvoc = WaveNetVocoder(tcfg, device="cpu").set_variables(tnet, tparams)
    mel = np.random.default_rng(0).random((4, 80)).astype(np.float32)
    return jvoc, tvoc, mel


def test_vocoder_argmax_round_trip(vocoders, tmp_path):
    """Temperature 0: the artifact equals the live port (the same codes),
    and JAX's artifact within 1e-5; a shorter mel is edge-held and
    trimmed, and equals the live vocoder on it; an empty mel and one of
    too many frames raise ClientError."""
    jvoc, tvoc, mel = vocoders
    out = export_vocoder(tvoc, str(tmp_path / "port"), frames=4, temperature=0.0)
    ex = ExportedVocoder(out, device="cpu")
    wav = ex.vocode(mel, seed=3)
    np.testing.assert_array_equal(wav, tvoc.vocode(mel, temperature=0.0, seed=3))
    jout = jexport.export_vocoder(jvoc, str(tmp_path / "jax"), frames=4,
                                  batch=1, temperature=0.0)
    np.testing.assert_allclose(wav, jexport.ExportedVocoder(jout).vocode(mel, seed=3),
                               atol=1e-5)
    with open(os.path.join(out, VOC_META_FILE)) as f:
        tmeta = json.load(f)
    with open(os.path.join(jout, jexport.VOC_META_FILE)) as f:
        jmeta = json.load(f)
    assert {k: v for k, v in tmeta.items() if k != "platforms"} \
        == {k: v for k, v in jmeta.items() if k != "platforms"}
    short = ex.vocode(mel[:2], seed=3)
    assert len(short) == 2 * ex.meta["hop"]
    np.testing.assert_array_equal(short, tvoc.vocode(mel[:2], temperature=0.0, seed=3))
    with pytest.raises(ClientError, match="frames=4"):
        ex.vocode(np.zeros((9, 80), np.float32))
    with pytest.raises(ClientError, match="empty"):
        ex.vocode(np.zeros((0, 80), np.float32))


def test_vocoder_sampled_round_trip(vocoders, tmp_path):
    """Temperature 1, one seed: the artifact's waveform equals the live
    port's bit for bit (the same Philox stream), and another seed draws
    another waveform."""
    _, tvoc, mel = vocoders
    ex = ExportedVocoder(export_vocoder(tvoc, str(tmp_path), frames=4),
                         device="cpu")
    wav = ex.vocode(mel, seed=11)
    np.testing.assert_array_equal(wav, tvoc.vocode(mel, temperature=1.0, seed=11))
    assert not np.array_equal(wav, ex.vocode(mel, seed=12))


def test_sampler_operator_registration(vocoders):
    """``nspeech::wavenet_sample`` passes torch's operator checks (schema,
    fake tensor, dispatch) on the CPU and equals ``WaveNet.generate``."""
    _, tvoc, _ = vocoders
    args = wavenet_op.operator_args(tvoc.net, tvoc._params)
    lc = torch.from_numpy(np.random.default_rng(1).random((1, 300, 80)).astype(np.float32))
    call = (args["packed"], args["weights"], lc, torch.tensor(5), 1.0,
            args["net_config"], args["weights_spec"], args["gc_ids"])
    torch.library.opcheck(torch.ops.nspeech.wavenet_sample.default, call)
    codes = torch.ops.nspeech.wavenet_sample(*call)
    ref = tvoc.net.generate(tvoc._params, 300, seed=5, lc=lc)
    assert codes.dtype == torch.int32 and torch.equal(codes, ref)


# -- the CLI and the demo server -----------------------------------------------

def test_export_serving_cli_round_trip(tmp_path, capsys):
    """``cli.export_serving`` from serving checkpoints of a Tacotron-2 and
    a vocoder: both programs serve what the live objects serve."""
    from nspeech_tpu_torch.cli import export_serving
    from nspeech_tpu_torch.train import save_serving_checkpoint

    tsyn = port_synth("taco2")
    save_serving_checkpoint(str(tmp_path / "taco"), 3, "taco2", tsyn.cfg,
                            tsyn._params, tsyn._bn_state)
    vcfg = t_load("wavenet").parse(VOC)
    net = WaveNet(vcfg)
    vparams = net.init(5)
    save_serving_checkpoint(str(tmp_path / "voc"), 9, "wavenet", vcfg, vparams)
    out = str(tmp_path / "art")
    export_serving.main(["--checkpoint", str(tmp_path / "taco"), "--out", out,
                         "--text-len", "16", "--device", "cpu",
                         "--vocoder-checkpoint", str(tmp_path / "voc"),
                         "--vocoder-frames", "3", "--temperature", "0"])
    said = capsys.readouterr().out
    assert "text_len=16" in said and "frames=3" in said
    _, mel, _ = ExportedSynthesizer(out, device="cpu").synthesize(TEXT)
    np.testing.assert_array_equal(mel, tsyn.synthesize(TEXT)[1])
    live = WaveNetVocoder(vcfg, device="cpu").set_variables(net, vparams)
    np.testing.assert_array_equal(
        ExportedVocoder(out, device="cpu").vocode(mel[:3], seed=2),
        live.vocode(mel[:3], temperature=0.0, seed=2))


def test_demo_server_serves_artifact(artifacts, monkeypatch):
    """``cli.demo_server --artifact`` (through ``DynamicBatcher``): 200
    audio/wav for a text that fits, 400 naming ``text_len`` for one
    beyond it (JAX's ``test_demo_server_serves_exported_artifact``)."""
    from nspeech_tpu_torch.cli import demo_server

    served = {}
    monkeypatch.setattr(demo_server, "serve_forever",
                        lambda app, port: served.update(app=app))
    demo_server.main(["--artifact", artifacts("taco2")[2], "--device", "cpu",
                      "--dynamic-batch", "2", "--batch-window-ms", "1"])
    said = {}

    def start_response(status, headers):
        said["status"], said["headers"] = status, dict(headers)

    app = served["app"]
    body = b"".join(app({"PATH_INFO": "/synthesize",
                         "QUERY_STRING": "text=hi+there"}, start_response))
    assert said["status"] == "200 OK"
    assert said["headers"]["Content-Type"] == "audio/wav"
    assert body[:4] == b"RIFF"
    body = b"".join(app({"PATH_INFO": "/synthesize", "QUERY_STRING":
                         "text=a+sentence+well+beyond+sixteen+symbols"},
                        start_response))
    assert said["status"].startswith("400") and b"text_len" in body
