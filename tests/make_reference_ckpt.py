"""Reference-named (TensorFlow) checkpoints made from a parameter tree.

The inverse of the importers' name mapping (``migrate/reference.py``,
``migrate/tacotron.py``): a WaveNet or Tacotron-2 tree in the ``init``
layout -> ``{reference variable name: ndarray}``, in the layout of the
synthetic name sets of ``tests/test_tf_import.py`` and
``tests/test_tf_import_taco.py`` (the WaveNet bias quirk ``Variable`` ..
``Variable_3``; the decoder's auto-generated wrapper scopes between
``decoder`` and its cells). ``write_bundle`` saves such a mapping as a
TensorFlow V2 bundle with TensorFlow's own ``SaveV2``. Used by the port's
import tests and by ``chip_smoke.py``'s import phase (which passes the
mapping to the importers directly: the card's machine has no
TensorFlow). Needs numpy alone, TensorFlow only for ``write_bundle``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_BIASES = ("filter_bias", "gate_bias", "dense_bias", "skip_bias")
_LAYER = ("filter", "gate", "dense", "skip", "gc_filter", "gc_gate",
          "lc_filter", "lc_gate")


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def wavenet_names(params) -> Dict[str, np.ndarray]:
    """A WaveNet tree (one-hot input) -> its reference checkpoint names."""
    t = {"wavenet/causal_layer/filter": _np(params["causal"])}
    for i, lp in enumerate(params["layers"]):
        base = f"wavenet/dilated_stack/layer{i}/"
        for key in _LAYER:
            if key in lp:
                t[base + key] = _np(lp[key])
        for j, key in enumerate(_BIASES):
            if key in lp:
                t[base + ("Variable" if j == 0 else f"Variable_{j}")] = _np(lp[key])
    if "gc_embedding" in params:
        t["wavenet/embeddings/gc_embedding"] = _np(params["gc_embedding"])
    t["wavenet/postprocessing/postprocess1"] = _np(params["post1"])
    t["wavenet/postprocessing/postprocess2"] = _np(params["post2"])
    if "post1_bias" in params:
        t["wavenet/postprocessing/Variable"] = _np(params["post1_bias"])
        t["wavenet/postprocessing/Variable_1"] = _np(params["post2_bias"])
    return t


def _conv_bn(t, base, p, s):
    t[base + "conv1d/kernel"] = _np(p["conv"]["kernel"])
    t[base + "conv1d/bias"] = _np(p["conv"]["bias"])
    bn = base + "batch_normalization/"
    t[bn + "gamma"] = _np(p["bn"]["scale"])
    t[bn + "beta"] = _np(p["bn"]["offset"])
    t[bn + "moving_mean"] = _np(s["bn"]["mean"])
    t[bn + "moving_variance"] = _np(s["bn"]["var"])


def _dense(t, base, p):
    t[base + "kernel"] = _np(p["kernel"])
    t[base + "bias"] = _np(p["bias"])


def taco2_names(params, bn_state, nest: str = "output_projection_wrapper/"
                "multi_rnn_cell") -> Dict[str, np.ndarray]:
    """A Tacotron-2 (params, bn_state) -> its reference checkpoint names;
    ``nest`` is the wrapper chain between ``decoder`` and the cells."""
    p, t = "model/inference/", {}
    t[p + "embedding/embedding"] = _np(params["embedding"]["table"])
    if "speaker_embed" in params:
        t[p + "speaker/speaker_embed"] = _np(params["speaker_embed"]["table"])
    for comp, conv in (("encoder", "encoder/conv_"), ("expand", "expand/conv_"),
                       ("postnet", "decoder_postnet/postnet_conv_")):
        for i, (cp, cs) in enumerate(zip(params[comp]["convs"],
                                         bn_state[comp]["convs"])):
            _conv_bn(t, p + f"{conv}{i}/", cp, cs)
    for comp in ("encoder", "expand"):
        for d in ("fw", "bw"):
            _dense(t, p + f"{comp}/encoder_lstm/{d}/lstm_block_cell/",
                   params[comp]["lstm_" + d])
    att = params["attention"]
    t[p + "attention_decoder/memory_layer/kernel"] = _np(att["memory_layer"]["kernel"])
    cell0 = p + f"decoder/{nest}/cell_0/attention_wrapper/"
    loc = cell0 + "location_sensitive_attention/"
    t[loc + "query_layer/kernel"] = _np(att["query_layer"]["kernel"])
    t[loc + "attention_v"] = _np(att["v"])
    t[loc + "location_conv/kernel"] = _np(att["location_conv"]["kernel"])
    t[loc + "location_layer/kernel"] = _np(att["location_layer"]["kernel"])
    for k, layer in enumerate(params["decoder_prenet"]["layers"]):
        _dense(t, cell0 + f"prenet_wrapper/decoder_prenet/dense_{k + 1}/", layer)
    if "spk_prenet" in params:
        _dense(t, cell0 + "prenet_wrapper/dense/", params["spk_prenet"])
    _dense(t, cell0 + "prenet_wrapper/lstm_block_cell/", params["attn_lstm"])
    for i, name in ((1, "lstm1"), (2, "lstm2")):
        _dense(t, p + f"decoder/{nest}/cell_{i}/lstm_block_cell/", params[name])
    _dense(t, p + "decoder/output_projection_wrapper/", params["frame_proj"])
    _dense(t, p + "dense/", params["postnet"]["out"])
    _dense(t, p + "dense_1/", params["linear_proj"])
    return t


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> str:
    """Save ``tensors`` under their names as a TensorFlow V2 checkpoint
    bundle (``<prefix>.index``, ``<prefix>.data-00000-of-00001``) with
    TensorFlow's ``SaveV2``, in graph mode (whatever the process's eager
    setting); returns ``prefix``."""
    import tensorflow as tf

    names = sorted(tensors)
    graph = tf.Graph()
    with graph.as_default():
        op = tf.raw_ops.SaveV2(
            prefix=prefix, tensor_names=names, shape_and_slices=[""] * len(names),
            tensors=[tf.constant(tensors[n]) for n in names])
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(op)
    return prefix
