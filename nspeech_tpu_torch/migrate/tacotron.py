"""Import trained reference (TensorFlow) Tacotron-1/2 checkpoints.

The reference's primary serving path restores Tacotron ``tf.train.Saver``
checkpoints (reference: neural_speech/synthesizer.py:34-38); this module
maps those checkpoints' variable names onto the ``Tacotron1.init`` /
``Tacotron2.init`` parameter trees (plus the batch-norm running-statistics
state tree), the same in the JAX package and the port. A copy of the JAX
package's ``nspeech_tpu/migrate/tacotron.py``, whose :func:`detect_model`
also closes the reader it opens.

Name-matching strategy — structural, not positional. A reference
Tacotron checkpoint's names have two parts:

* **Explicit scopes the reference source sets itself** — ``inference``,
  ``prenet``, ``encoder_cbhg``/``post_cbhg`` (+ ``conv_bank/conv1d_k``,
  ``proj_k``, ``highway_i``), ``attention_decoder``, ``decoder``,
  ``decoder_prenet``, ``encoder``/``expand`` (+ ``conv_i``,
  ``encoder_lstm``), ``decoder_postnet`` (reference:
  models/tacotron.py:34-98, models/utils/modules.py). These are stable
  landmarks and are matched exactly.
* **Auto-generated wrapper scopes** TF1 layers/cells produce between
  ``decoder`` and the leaves (``output_projection_wrapper``,
  ``multi_rnn_cell/cell_%d``, ``attention_wrapper`` ...). Only the
  informative segments are matched (``cell_0/1/2``, the cell-type leaf
  scopes ``gru_cell``/``lstm_block_cell``/``lstm_cell``, the attention
  scopes ``bahdanau_attention``/``location_sensitive_attention`` and
  their TF1-hardcoded leaves ``attention_v``/``query_layer`` etc.) so
  the import is insensitive to exactly how the wrapper chain nested —
  which varies with TF minor versions.

TF1 layouts equal ours leaf-for-leaf (dense kernels [in, out]; conv1d
kernels [width, in, out]; GRU gates kernel [in+u, 2u] in (reset, update)
order; LSTM kernels [in+u, 4u] in (i, j, f, o) order with runtime forget
bias) so the import is a pure rename — no transposes. Batch-norm
``gamma/beta`` map to params ``scale/offset`` and
``moving_mean/moving_variance`` to the state tree's ``mean/var``.

The port's mapping is held to the JAX package's, tree for tree, in
``tests/test_torch_migrate.py``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from nspeech_tpu_torch.migrate.reference import (ImportError_,
                                                 _is_optimizer_slot, _tensors)
from nspeech_tpu_torch.migrate.tfbundle import TFBundleReader

_BN_PARAM = {"gamma": "scale", "beta": "offset"}
_BN_STATE = {"moving_mean": "mean", "moving_variance": "var"}
_GRU_LEAF = {("gates", "kernel"): "gate_kernel",
             ("gates", "bias"): "gate_bias",
             ("candidate", "kernel"): "cand_kernel",
             ("candidate", "bias"): "cand_bias"}

# TF1 cell-scope names for the LSTM variants the reference can produce
# (contrib LSTMBlockCell vs core LSTMCell/BasicLSTMCell under different
# TF minors).
_LSTM_SCOPES = ("lstm_block_cell", "lstm_cell", "basic_lstm_cell")

# Attention scope names (one per mechanism family) — TF1 hardcodes these
# as the mechanisms' default base names.
_ATTN_SCOPES = ("bahdanau_attention", "bahdanau_monotonic_attention",
                "location_sensitive_attention", "luong_attention")


def _strip_prefixes(name: str) -> Optional[str]:
    """'model/inference/...' or 'inference/...' -> '...'; None when the
    variable is not part of the inference graph (global_step etc.)."""
    segs = name.split("/")
    if segs and segs[0] == "model":
        segs = segs[1:]
    if not segs or segs[0] != "inference":
        return None
    return "/".join(segs[1:])


class _TreeBuilder:
    """Accumulates (path tuple -> array) assignments, then materializes
    nested dicts/lists (list levels are integer-keyed)."""

    def __init__(self):
        self.slots: Dict[Tuple, np.ndarray] = {}

    def put(self, path: Tuple, arr: np.ndarray, src: str) -> None:
        if path in self.slots:
            raise ImportError_(f"duplicate mapping for {path} (from {src})")
        self.slots[path] = np.asarray(arr, np.float32)

    def build(self):
        root: Dict[Any, Any] = {}
        for path, arr in self.slots.items():
            node = root
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = arr
        return _listify(root)


def _listify(node):
    """Convert integer-keyed dicts to lists (contiguous from 0)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        idxs = sorted(out)
        if idxs != list(range(len(idxs))):
            raise ImportError_(f"non-contiguous indices {idxs}")
        return [out[i] for i in idxs]
    return out


def _conv_bn_leaf(segs: List[str]):
    """['conv1d','kernel'] / ['batch_normalization','gamma'] ->
    ('params', subpath) or ('state', subpath); None if unrecognized."""
    if len(segs) != 2:
        return None
    group, leaf = segs
    if group == "conv1d" and leaf in ("kernel", "bias"):
        return "params", ("conv", leaf)
    if group == "batch_normalization":
        if leaf in _BN_PARAM:
            return "params", ("bn", _BN_PARAM[leaf])
        if leaf in _BN_STATE:
            return "state", ("bn", _BN_STATE[leaf])
    return None


def _index(seg: str, prefix: str) -> Optional[int]:
    m = re.fullmatch(re.escape(prefix) + r"_?(\d+)", seg)
    return int(m.group(1)) if m else None


class _Mapper:
    def __init__(self, model: str):
        assert model in ("taco1", "taco2")
        self.model = model
        self.params = _TreeBuilder()
        self.state = _TreeBuilder()
        self.unmapped: List[str] = []
        # unnamed top-level denses ('dense', 'dense_1'): resolved by
        # shape after everything else is known
        self.top_dense: Dict[str, Dict[str, np.ndarray]] = {}
        self.cbhg_dense: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}

    # -- region handlers ----------------------------------------------------

    def _cbhg(self, region: str, segs: List[str], arr, src: str) -> bool:
        tree = "encoder_cbhg" if region == "encoder_cbhg" else "post_cbhg"
        if segs[0] == "conv_bank":
            k = _index(segs[1], "conv1d")
            dest = _conv_bn_leaf(segs[2:])
            if k is None or dest is None:
                return False
            which, sub = dest
            getattr(self, which).put((tree, "bank", k - 1) + sub, arr, src)
            return True
        k = _index(segs[0], "proj")
        if k is not None:
            dest = _conv_bn_leaf(segs[1:])
            if dest is None:
                return False
            which, sub = dest
            getattr(self, which).put((tree, "proj", k - 1) + sub, arr, src)
            return True
        i = _index(segs[0], "highway")
        if i is not None:
            if segs[1] == "highway" and segs[2] in ("H", "T") and \
                    segs[3] in ("kernel", "bias"):
                self.params.put((tree, "highways", i, "hw", segs[2],
                                 segs[3]), arr, src)
                return True
            if segs[1].startswith("dense") and segs[2] in ("kernel", "bias"):
                self.params.put((tree, "highways", i, "spk", segs[2]),
                                arr, src)
                return True
            return False
        if segs[0] == "bidirectional_rnn" and segs[1] in ("fw", "bw"):
            leaf = _GRU_LEAF.get((segs[3], segs[4])) if len(segs) == 5 else None
            if segs[2] != "gru_cell" or leaf is None:
                return False
            self.params.put((tree, "gru_" + segs[1], leaf), arr, src)
            return True
        if segs[0].startswith("dense") and segs[1] in ("kernel", "bias"):
            # bottleneck vs speaker-GRU-state dense: resolved by shape in
            # finish() once in_dim / speaker dim are known
            self.cbhg_dense.setdefault((tree, segs[0]), {})[segs[1]] = arr
            return True
        return False

    def _conv_stack(self, tree: Tuple, prefix: str, segs: List[str], arr,
                    src: str) -> bool:
        i = _index(segs[0], prefix)
        if i is None:
            return False
        dest = _conv_bn_leaf(segs[1:])
        if dest is None:
            return False
        which, sub = dest
        getattr(self, which).put(tree + ("convs", i) + sub, arr, src)
        return True

    def _bilstm(self, tree: Tuple, segs: List[str], arr, src: str) -> bool:
        # encoder_lstm/{fw,bw}/<lstm scope>/{kernel,bias}
        if segs[0] != "encoder_lstm" or segs[1] not in ("fw", "bw"):
            return False
        if len(segs) == 4 and segs[2] in _LSTM_SCOPES and \
                segs[3] in ("kernel", "bias"):
            self.params.put(tree + ("lstm_" + segs[1], segs[3]), arr, src)
            return True
        return False

    def _attention(self, segs: List[str], arr, src: str) -> bool:
        """Leaves under any attention-mechanism scope (suffix match)."""
        tail = segs[-2:] if len(segs) >= 2 else segs
        if tail == ["memory_layer", "kernel"]:
            self.params.put(("attention", "memory_layer", "kernel"), arr, src)
        elif tail == ["query_layer", "kernel"]:
            self.params.put(("attention", "query_layer", "kernel"), arr, src)
        elif tail == ["location_conv", "kernel"]:
            self.params.put(("attention", "location_conv", "kernel"), arr, src)
        elif tail == ["location_layer", "kernel"]:
            self.params.put(("attention", "location_layer", "kernel"), arr, src)
        elif segs[-1] == "attention_v":
            self.params.put(("attention", "v"), arr, src)
        elif segs[-1] == "attention_g":
            self.params.put(("attention", "g"), arr, src)
        elif segs[-1] == "attention_b":
            self.params.put(("attention", "b"), arr, src)
        elif segs[-1] == "attention_score_bias":
            self.params.put(("attention", "score_bias"), arr, src)
        else:
            return False
        return True

    def _decoder_cell(self, cell_idx: int, segs: List[str], arr,
                      src: str) -> bool:
        """Leaves under decoder cell_{idx} (past the attention/prenet
        rules, which run first)."""
        taco1_cells = {0: "attn_gru", 1: "gru2", 2: "gru3"}
        taco2_cells = {0: "attn_lstm", 1: "lstm1", 2: "lstm2"}
        if "gru_cell" in segs:
            leaf = _GRU_LEAF.get(tuple(segs[-2:]))
            if leaf is None:
                return False
            self.params.put((taco1_cells[cell_idx], leaf), arr, src)
            return True
        if any(s in _LSTM_SCOPES for s in segs):
            if segs[-1] not in ("kernel", "bias"):
                return False
            self.params.put((taco2_cells[cell_idx], segs[-1]), arr, src)
            return True
        if segs[-2] == "output_projection_wrapper" and \
                segs[-1] in ("kernel", "bias"):
            # taco1's inner OutputProjectionWrapper(attention_cell, 256)
            self.params.put(("out_proj", segs[-1]), arr, src)
            return True
        if segs[-2].startswith("dense") and segs[-1] in ("kernel", "bias"):
            # PrenetWrapper's per-step speaker projection
            self.params.put(("spk_prenet", segs[-1]), arr, src)
            return True
        return False

    # -- dispatch -----------------------------------------------------------

    def feed(self, name: str, arr: np.ndarray) -> None:
        rel = _strip_prefixes(name)
        if rel is None:
            return  # optimizer/global_step/non-model — ignored
        segs = rel.split("/")
        src = name
        ok = False
        if segs[0] == "embedding" and segs[-1] == "embedding":
            self.params.put(("embedding", "table"), arr, src)
            ok = True
        elif segs[0] == "speaker" and segs[-1] == "speaker_embed":
            self.params.put(("speaker_embed", "table"), arr, src)
            ok = True
        elif segs[0] == "prenet":
            k = _index(segs[1], "dense")
            if k is not None and segs[2] in ("kernel", "bias"):
                self.params.put(("encoder_prenet", "layers", k - 1, segs[2]),
                                arr, src)
                ok = True
        elif segs[0] in ("encoder_cbhg", "post_cbhg"):
            ok = self._cbhg(segs[0], segs[1:], arr, src)
        elif segs[0] == "attention_decoder":
            ok = self._attention(segs[1:], arr, src)
        elif segs[0] == "encoder":
            ok = (self._conv_stack(("encoder",), "conv", segs[1:], arr, src)
                  or self._bilstm(("encoder",), segs[1:], arr, src))
        elif segs[0] == "expand":
            ok = (self._conv_stack(("expand",), "conv", segs[1:], arr, src)
                  or self._bilstm(("expand",), segs[1:], arr, src))
        elif segs[0] == "decoder_postnet":
            ok = self._conv_stack(("postnet",), "postnet_conv", segs[1:],
                                  arr, src)
        elif segs[0] == "decoder":
            if "decoder_prenet" in segs:
                j = segs.index("decoder_prenet")
                k = _index(segs[j + 1], "dense")
                if k is not None and segs[j + 2] in ("kernel", "bias"):
                    self.params.put(
                        ("decoder_prenet", "layers", k - 1, segs[j + 2]),
                        arr, src)
                    ok = True
            elif any(s in _ATTN_SCOPES for s in segs):
                ok = self._attention(segs, arr, src)
            else:
                cell = next((i for i in range(3) if f"cell_{i}" in segs),
                            None)
                if cell is not None:
                    ok = self._decoder_cell(cell, segs, arr, src)
                elif segs[-2] == "output_projection_wrapper" and \
                        segs[-1] in ("kernel", "bias"):
                    # the outer frame projection (M*r)
                    self.params.put(("frame_proj", segs[-1]), arr, src)
                    ok = True
        elif segs[0].startswith("dense") and len(segs) == 2 and \
                segs[1] in ("kernel", "bias"):
            self.top_dense.setdefault(segs[0], {})[segs[1]] = arr
            ok = True
        if not ok:
            self.unmapped.append(name)

    # -- post-pass ----------------------------------------------------------

    def finish(self):
        if self.unmapped:
            raise ImportError_(
                f"unmapped inference variables: {sorted(self.unmapped)}")
        self._resolve_cbhg_dense()
        self._resolve_top_dense()
        params = self.params.build()
        state_raw = self.state.build()
        return params, self._shape_state(params, state_raw)

    def _resolve_cbhg_dense(self):
        """Unnamed denses directly under a CBHG scope: the 128-bottleneck
        (created first, when in_dim != 128 — reference modules.py:149-151)
        vs the speaker GRU-state projection (gru_units out). Disambiguate
        by input dim against the residual width; tie-break by creation
        order ('dense' precedes 'dense_1')."""
        for (tree, _dname), leaves in sorted(self.cbhg_dense.items()):
            kernel = leaves.get("kernel")
            if kernel is None:
                raise ImportError_(f"{tree} dense missing kernel")
            # The CBHG residual width == its proj stack's final out-channels
            proj_last = max(k[2] for k in self.params.slots
                            if len(k) > 3 and k[0] == tree and k[1] == "proj")
            in_dim = int(self.params.slots[
                (tree, "proj", proj_last, "conv", "kernel")].shape[2])
            is_bottleneck = (int(kernel.shape[0]) == in_dim != 128
                             and (tree, "bottleneck", "kernel")
                             not in self.params.slots)
            dest = "bottleneck" if is_bottleneck else "spk_gru"
            for leaf, arr in leaves.items():
                self.params.put((tree, dest, leaf), arr, f"{tree} dense")

    def _resolve_top_dense(self):
        """'inference/dense[_1]': taco1 has one (the linear projection,
        reference tacotron.py:98); taco2 has two — the postnet output
        dense (created first; its in_dim equals the last postnet conv's
        channels) and the linear projection (in_dim = 2*expand_lstm)."""
        items = sorted(self.top_dense.items())
        if self.model == "taco1":
            if len(items) != 1:
                raise ImportError_(
                    f"taco1 expects one top-level dense, got "
                    f"{[k for k, _ in items]}")
            for leaf, arr in items[0][1].items():
                self.params.put(("linear_proj", leaf), arr, items[0][0])
            return
        if len(items) != 2:
            raise ImportError_(
                f"taco2 expects two top-level denses (postnet out + "
                f"linear), got {[k for k, _ in items]}")
        post_ch = None
        post_idxs = [k[2] for k in self.params.slots
                     if len(k) > 3 and k[0] == "postnet" and k[1] == "convs"]
        if post_idxs:
            post_ch = int(self.params.slots[
                ("postnet", "convs", max(post_idxs), "conv",
                 "kernel")].shape[2])
        a, b = items
        a_in = int(a[1]["kernel"].shape[0])
        if a_in == post_ch:
            post, linear = a, b
        else:
            b_in = int(b[1]["kernel"].shape[0])
            if b_in == post_ch:
                post, linear = b, a
            else:
                raise ImportError_(
                    f"cannot identify postnet-out dense: in_dims "
                    f"({a_in}, {b_in}) vs postnet channels {post_ch}")
        for leaf, arr in post[1].items():
            self.params.put(("postnet", "out", leaf), arr, post[0])
        for leaf, arr in linear[1].items():
            self.params.put(("linear_proj", leaf), arr, linear[0])

    def _shape_state(self, params, state_raw):
        """Arrange the BN state tree exactly as ``Model.init`` returns it
        (taco1: {encoder_cbhg:{bank,proj}, post_cbhg:{...}}; taco2:
        {encoder:{convs}, postnet:{convs}, expand:{convs}})."""
        if self.model == "taco1":
            return {k: state_raw.get(k, {})
                    for k in ("encoder_cbhg", "post_cbhg")}
        return {k: state_raw.get(k, {}) for k in ("encoder", "postnet",
                                                  "expand")}


def import_tacotron(src, model: str) -> Tuple[Dict[str, Any], Dict[str, Any],
                                              Dict[str, Any]]:
    """Map a reference Tacotron checkpoint to (params, bn_state, hparams).

    ``src`` is a checkpoint prefix path, a TFBundleReader, or a
    ``{name: ndarray}`` mapping; ``model`` is 'taco1' or 'taco2'
    (detectable via :func:`detect_model`). Returns our ``init``-shaped
    trees plus every hparam the weight shapes determine.
    """
    tensors = {name: arr for name, arr in _tensors(src).items()
               if not _is_optimizer_slot(name)}
    if not any(_strip_prefixes(n) for n in tensors):
        raise ImportError_(
            "no 'inference/' variables — not a reference Tacotron "
            f"checkpoint (found {len(tensors)} variables)")
    mapper = _Mapper(model)
    for name, arr in sorted(tensors.items()):
        mapper.feed(name, arr)
    params, bn_state = mapper.finish()
    return params, bn_state, _derive_hparams(model, params)


def detect_model(src) -> str:
    """'taco1' | 'taco2' | 'wavenet' from a checkpoint's variable names.

    Reads the bundle INDEX only — no tensor payloads are decoded (the
    reader checksums every byte it decodes, which for a full training
    checkpoint is hundreds of MB of pure-Python CRC work the detection
    doesn't need)."""
    if isinstance(src, dict):
        names = list(src.keys())
    elif isinstance(src, TFBundleReader):
        names = src.variable_names()
    else:
        with TFBundleReader(src) as reader:
            names = reader.variable_names()
    if any(n.startswith("wavenet/") for n in names):
        return "wavenet"
    rels = [r for r in (_strip_prefixes(n) for n in names) if r]
    if any(r.startswith("encoder_cbhg/") for r in rels):
        return "taco1"
    if any(r.startswith("encoder/") for r in rels):
        return "taco2"
    raise ImportError_("cannot detect a reference model in this checkpoint")


def _derive_hparams(model: str, params) -> Dict[str, Any]:
    """Everything the weight shapes pin down, in our config's keys."""
    hp: Dict[str, Any] = {}
    emb = params["embedding"]["table"]
    hp["embedding_dim"] = int(emb.shape[1])
    if "speaker_embed" in params:
        tbl = params["speaker_embed"]["table"]
        hp["num_speakers"] = int(tbl.shape[0])
        hp["speaker_embed_dim"] = int(tbl.shape[1])
    else:
        hp["num_speakers"] = 1
    att = params["attention"]
    hp["attention_dim"] = int(att["memory_layer"]["kernel"].shape[1])
    hp["attention_type"] = _attention_type(att)
    hp["num_freq"] = int(params["linear_proj"]["kernel"].shape[1])
    if model == "taco1":
        hp["encoder_prenet"] = [int(l["kernel"].shape[1])
                                for l in params["encoder_prenet"]["layers"]]
        cb = params["encoder_cbhg"]
        hp["encoder_cbhg_banks"] = len(cb["bank"])
        hp["encoder_cbhg_bank_sizes"] = [
            int(p["conv"]["kernel"].shape[2]) for p in cb["proj"]]
        pb = params["post_cbhg"]
        hp["post_cbhg_banks"] = len(pb["bank"])
        proj_sizes = [int(p["conv"]["kernel"].shape[2]) for p in pb["proj"]]
        hp["num_mels"] = proj_sizes[-1]  # post-CBHG projects back to mels
        hp["post_cbhg_bank_sizes"] = proj_sizes[:-1]
        hp["decoder_dim"] = int(params["out_proj"]["kernel"].shape[1])
    else:
        enc = params["encoder"]
        hp["encoder_conv_layers"] = len(enc["convs"])
        k0 = enc["convs"][0]["conv"]["kernel"]
        hp["encoder_conv_width"] = int(k0.shape[0])
        hp["encoder_conv_channels"] = int(k0.shape[2])
        hp["encoder_lstm_units"] = int(enc["lstm_fw"]["kernel"].shape[1]) // 4
        hp["decoder_lstm_units"] = int(
            params["lstm1"]["kernel"].shape[1]) // 4
        pn = params["postnet"]
        hp["postnet_conv_layers"] = len(pn["convs"])
        pk0 = pn["convs"][0]["conv"]["kernel"]
        hp["postnet_conv_width"] = int(pk0.shape[0])
        hp["postnet_conv_channels"] = int(pk0.shape[2])
        hp["num_mels"] = int(pn["out"]["kernel"].shape[1])
        ex = params["expand"]
        hp["expand_conv_layers"] = len(ex["convs"])
        ek0 = ex["convs"][0]["conv"]["kernel"]
        hp["expand_conv_width"] = int(ek0.shape[0])
        hp["expand_conv_channels"] = int(ek0.shape[2])
        hp["expand_lstm_units"] = int(ex["lstm_fw"]["kernel"].shape[1]) // 4
    r_times_m = int(params["frame_proj"]["kernel"].shape[1])
    if r_times_m % hp["num_mels"]:
        raise ImportError_(
            f"frame projection width {r_times_m} is not a multiple of "
            f"num_mels {hp['num_mels']}")
    hp["outputs_per_step"] = r_times_m // hp["num_mels"]
    return hp


def _attention_type(att) -> str:
    if "location_conv" in att:
        return "location_sensitive"
    if "score_bias" in att:
        return "bah_mon"
    if "v" in att:
        return "bah_norm" if "g" in att else "bah"
    return "luong_scaled" if "g" in att else "luong"
