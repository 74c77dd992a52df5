"""The port's run metadata and serving checkpoint, and the exporter that
turns a JAX (Orbax) checkpoint into one (``scripts/export_torch_checkpoint.py``).

The metadata tests mirror ``tests/test_metadata.py`` on the port's models
(Tacotron-1 is not ported: its checkpoints raise). Checkpoint round trips
are exact (float32 arrays written and read back)."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.train import (CheckpointManager, create_state, make_optimizer)
from nspeech_tpu.train import save_run_metadata as j_save_meta
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.models import Tacotron2, WaveNet
from nspeech_tpu_torch.serving import Synthesizer, WaveNetVocoder
from nspeech_tpu_torch.train import (config_from_checkpoint, load_run_metadata,
                                     load_serving_params,
                                     save_run_metadata,
                                     save_serving_checkpoint)

torch.set_num_threads(1)

WN = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
      "dilation_channels=8,skip_channels=16,quantization_channels=64,"
      "lc_channels=5,gc_channels=4,gc_category_cardinality=3")
TACO = ("max_iters=4,encoder_conv_layers=1,postnet_conv_layers=1,"
        "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
        "postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
        "embedding_dim=16,griffin_lim_iters=2")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint",
        os.path.join(ROOT, "scripts", "export_torch_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def same_trees(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_metadata_roundtrip(tmp_path):
    cfg = load_config("taco2")
    cfg.num_speakers = 7
    spk_map = {("vctk", "p225"): 0, ("vctk", "p226"): 1, ("arctic", "bdl"): 2}
    path = save_run_metadata(str(tmp_path), "taco2", cfg, speaker_map=spk_map)
    assert path.endswith("config.json")
    meta = load_run_metadata(str(tmp_path))
    assert meta["model"] == "taco2" and meta["hparams"]["num_speakers"] == 7
    assert ["vctk", "p226", 1] in meta["speaker_map"]
    # the same file as the JAX package writes for the same config
    j_cfg = j_load("taco2")
    j_cfg.num_speakers = 7
    j_save_meta(str(tmp_path / "j"), "taco2", j_cfg, speaker_map=spk_map)
    assert json.loads((tmp_path / "j" / "config.json").read_text()) == meta


def test_config_from_checkpoint_precedence(tmp_path):
    cfg = load_config("taco2")
    cfg.num_speakers = 4
    save_run_metadata(str(tmp_path), "taco2", cfg)

    # metadata wins over the defaults; overrides applied last
    out, name = config_from_checkpoint(str(tmp_path))
    assert name == "taco2" and out.num_speakers == 4
    out, _ = config_from_checkpoint(str(tmp_path), overrides="num_speakers=9")
    assert out.num_speakers == 9
    # explicit model name beats metadata; default_model is the last resort
    out, name = config_from_checkpoint(str(tmp_path), model_name="wavenet")
    assert name == "wavenet"

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no run metadata"):
        config_from_checkpoint(str(empty))
    out, name = config_from_checkpoint(str(empty), default_model="wavenet")
    assert name == "wavenet" and out.quantization_channels == 256

    # a key missing from old metadata keeps its current default
    meta = json.loads((tmp_path / "config.json").read_text())
    del meta["hparams"]["max_iters"]
    (tmp_path / "config.json").write_text(json.dumps(meta))
    out, _ = config_from_checkpoint(str(tmp_path))
    assert out.max_iters == load_config("taco2").max_iters


def test_taco1_checkpoint_is_not_ported(tmp_path):
    j_save_meta(str(tmp_path), "taco1", j_load("taco1"))
    with pytest.raises(NotImplementedError, match="item 11"):
        config_from_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 11"):
        Synthesizer.from_checkpoint(str(tmp_path), device="cpu")


def test_serving_checkpoint_roundtrip(tmp_path):
    cfg = load_config("wavenet").parse(WN)
    net = WaveNet(cfg)
    old, new = net.init(1), net.init(2)
    save_serving_checkpoint(str(tmp_path), 10, "wavenet", cfg, old)
    save_serving_checkpoint(str(tmp_path), 20, "wavenet", cfg, new)
    got, bn = load_serving_params(str(tmp_path), net)          # latest step
    assert bn is None and same_trees(got, new)
    got, _ = load_serving_params(str(tmp_path), net, step=10)
    assert same_trees(got, old)
    with pytest.raises(FileNotFoundError):
        load_serving_params(str(tmp_path), net, step=15)
    voc = WaveNetVocoder.from_checkpoint(str(tmp_path), device="cpu")
    assert voc.net.lc_channels == 5 and same_trees(voc._params, new)

    tcfg = load_config("taco2").parse(TACO)
    model = Tacotron2(tcfg)
    params, bn_state = model.init(3)
    save_serving_checkpoint(str(tmp_path / "taco"), 0, "taco2", tcfg,
                            params, bn_state)
    syn = Synthesizer.from_checkpoint(str(tmp_path / "taco"), device="cpu")
    assert syn.cfg.decoder_lstm_units == 16
    assert same_trees((syn._params, syn._bn_state), (params, bn_state))


def test_serving_checkpoint_rejects_bad_trees(tmp_path):
    cfg = load_config("wavenet").parse(WN)
    net = WaveNet(cfg)
    params = net.init(0)
    bad = dict(params, causal=params["causal"][:, :10])
    save_serving_checkpoint(str(tmp_path / "shape"), 0, "wavenet", cfg, bad)
    with pytest.raises(ValueError, match="shape"):
        load_serving_params(str(tmp_path / "shape"), net)
    missing = {k: v for k, v in params.items() if k != "post2"}
    save_serving_checkpoint(str(tmp_path / "missing"), 0, "wavenet", cfg, missing)
    with pytest.raises(ValueError, match="missing"):
        load_serving_params(str(tmp_path / "missing"), net)
    extra = dict(params, extra=torch.zeros(3))
    save_serving_checkpoint(str(tmp_path / "extra"), 0, "wavenet", cfg, extra)
    with pytest.raises(ValueError, match="not consumed"):
        load_serving_params(str(tmp_path / "extra"), net)
    with pytest.raises(FileNotFoundError):
        load_serving_params(str(tmp_path / "none"), net)


def test_export_prefers_ema_and_keeps_bn_state(tmp_path):
    """An Orbax Tacotron-2 checkpoint with an EMA average exports to the
    archive the port reads: the EMA params (not the raw ones) and the
    batch-norm state, equal to the bridged JAX trees."""
    jcfg = j_load("taco2").parse(TACO + ",ema_decay=0.99,num_speakers=3")
    model = j_create("taco2", jcfg)
    tx, _ = make_optimizer(jcfg, "taco2")
    state = create_state(model, tx, jax.random.PRNGKey(0), ema=True)
    state = state._replace(ema_params=jax.tree_util.tree_map(
        lambda p: p * 0.5 + 0.25, state.params))
    ckpt = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt)
    mgr.save(7, state)
    mgr.wait()
    mgr.close()
    j_save_meta(ckpt, "taco2", jcfg,
                speaker_map={("synth", str(i)): i for i in range(3)})
    path = exporter().export(ckpt, str(tmp_path / "port"))
    assert path.endswith(os.path.join("serving", "7.npz"))

    syn = Synthesizer.from_checkpoint(str(tmp_path / "port"), device="cpu")
    assert syn.cfg.num_speakers == 3 and syn.cfg.ema_decay == 0.99
    assert load_run_metadata(str(tmp_path / "port"))["speaker_map"][2] == ["synth", "2", 2]
    want = convert.tacotron2_variables(
        syn.model, jax.tree_util.tree_map(np.asarray, state.ema_params),
        jax.tree_util.tree_map(np.asarray, state.bn_state))
    assert same_trees((syn._params, syn._bn_state), want)
