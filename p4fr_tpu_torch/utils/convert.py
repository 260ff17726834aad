"""Weight bridge between JAX parameter trees and reference-named torch
state dicts, both ways.

The port's own copy of the rule tables of
``p4fr_tpu/utils/convert_pth.py`` for every family (LiteSATRN,
EfficientSATRN, SwinTRN, EfficientASTER), and of the pretrained-backbone
bootstrap's tables for timm's EfficientNetV2-S blocks and Microsoft's Swin
hub file (``bootstrap_pretrained``, at the end of this file).
The rule tables map each reference torch key (regex) to a flax path
template and a layout transform. ``export_state_dict`` inverts them, so the
result is exactly the reference ``.pth`` layout the port's modules load;
``flax_trees`` applies them forward, giving the ``params`` and
``batch_stats`` trees of the JAX package's native checkpoint:

- Linear  weight [O,I]       <- kernel [I,O] (transpose)
- Conv2d  weight [O,I,kh,kw] <- kernel [kh,kw,I,O]
- depthwise conv [C,1,k,k]   <- kernel [k,k,1,C]
- BatchNorm weight/bias      <- scale/bias; running stats <- batch_stats
- LayerNorm weight           <- scale

"drop" rules (``num_batches_tracked``; EfficientASTER's dead ``conv2``
stage) have no inverse: the modules rebuild those buffers themselves, and
``DeepCNN`` drops the ``conv2`` keys of a reference ``.pth`` on load. A
one-layer ASTER decoder keeps a bare LSTM cell at ``rnn.`` (the reference
names the cells ``rnn.{i}.`` only for more than one layer).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# forward transforms (torch layout -> flax layout) and their inverses
# ---------------------------------------------------------------------------


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _t_depthwise(w: np.ndarray) -> np.ndarray:
    # torch [C, 1, kh, kw] -> flax [kh, kw, 1, C]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _identity(w: np.ndarray) -> np.ndarray:
    # a copy: the input may be a view of live storage
    return np.array(w, copy=True)


def _inv_conv(w: np.ndarray) -> np.ndarray:
    # flax [kh, kw, I, O] -> torch [O, I, kh, kw]
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


_INV_TRANSFORM = {
    _identity: _identity,
    _t_linear: _t_linear,  # transpose is its own inverse
    _t_conv: _inv_conv,
    _t_depthwise: _inv_conv,
}

# ---------------------------------------------------------------------------
# rule tables: (regex on torch key) -> (flax path template, transform, coll)
# coll: "params" | "batch_stats" | "drop"
# ---------------------------------------------------------------------------

Rule = Tuple[str, str, Callable[[np.ndarray], np.ndarray], str]


def _norm_rules(torch_prefix: str, flax_prefix: str) -> List[Rule]:
    """BatchNorm2d param/stat rules."""
    return [
        (rf"{torch_prefix}\.weight$", f"{flax_prefix}/scale", _identity, "params"),
        (rf"{torch_prefix}\.bias$", f"{flax_prefix}/bias", _identity, "params"),
        (rf"{torch_prefix}\.running_mean$", f"{flax_prefix}/mean", _identity,
         "batch_stats"),
        (rf"{torch_prefix}\.running_var$", f"{flax_prefix}/var", _identity,
         "batch_stats"),
        (rf"{torch_prefix}\.num_batches_tracked$", "", _identity, "drop"),
    ]


def _ln_rules(torch_prefix: str, flax_prefix: str) -> List[Rule]:
    return [
        (rf"{torch_prefix}\.weight$", f"{flax_prefix}/scale", _identity, "params"),
        (rf"{torch_prefix}\.bias$", f"{flax_prefix}/bias", _identity, "params"),
    ]


def _linear_rules(torch_prefix: str, flax_prefix: str) -> List[Rule]:
    return [
        (rf"{torch_prefix}\.weight$", f"{flax_prefix}/kernel", _t_linear, "params"),
        (rf"{torch_prefix}\.bias$", f"{flax_prefix}/bias", _identity, "params"),
    ]


def _conv_rules(torch_prefix: str, flax_prefix: str) -> List[Rule]:
    return [
        (rf"{torch_prefix}\.weight$", f"{flax_prefix}/kernel", _t_conv, "params"),
        (rf"{torch_prefix}\.bias$", f"{flax_prefix}/bias", _identity, "params"),
    ]


def _mha_rules(torch_prefix: str, flax_prefix: str) -> List[Rule]:
    rules: List[Rule] = []
    for name in ("q_linear", "k_linear", "v_linear", "out_linear"):
        rules += _linear_rules(rf"{torch_prefix}\.{name}", f"{flax_prefix}/{name}")
    return rules


def _transformer_decoder_rules(ff_naming: str = "linear") -> List[Rule]:
    """decoder.* of the SATRN and SWIN families. ``ff_naming``: the SATRN
    Feedforward names its Linears ``linear0``/``linear1``; SWIN.py's is an
    ``nn.Sequential`` with its Linears at ``layers.0``/``layers.3``
    ("sequential")."""
    p = r"decoder\.attention_layers\.(\d+)"
    f = r"decoder/layer\1"
    rules: List[Rule] = [
        (r"decoder\.embedding\.weight$", "decoder/embedding/embedding",
         _identity, "params"),
    ]
    rules += _mha_rules(rf"{p}\.self_attention_layer", rf"{f}/self_attention")
    rules += _ln_rules(rf"{p}\.self_attention_norm", rf"{f}/self_attention_norm")
    rules += _mha_rules(rf"{p}\.attention_layer", rf"{f}/cross_attention")
    rules += _ln_rules(rf"{p}\.attention_norm", rf"{f}/cross_attention_norm")
    first, second = (("layers\\.0", "layers\\.3") if ff_naming == "sequential"
                     else ("linear0", "linear1"))
    rules += _linear_rules(rf"{p}\.feedforward_layer\.{first}",
                           rf"{f}/feedforward/linear0")
    rules += _linear_rules(rf"{p}\.feedforward_layer\.{second}",
                           rf"{f}/feedforward/linear1")
    rules += _ln_rules(rf"{p}\.feedforward_norm", rf"{f}/feedforward_norm")
    rules += _linear_rules(r"decoder\.generator", "decoder/generator")
    return rules


def _efficientnet_rules(torch_root: str, flax_root: str) -> List[Rule]:
    """timm ``blocks.{s}.{b}`` -> ``stage{s}_block{b}`` naming."""
    rules: List[Rule] = []
    b = rf"{torch_root}\.(\d+)\.(\d+)"
    fb = rf"{flax_root}/stage\1_block\2"
    rules += _conv_rules(rf"{b}\.conv", rf"{fb}/conv")  # ConvBnAct (stage 0)
    rules += _conv_rules(rf"{b}\.conv_exp", rf"{fb}/conv_exp")  # stages 1-2
    rules += _conv_rules(rf"{b}\.conv_pw", rf"{fb}/conv_pw")  # stages 3-5
    rules += [
        (rf"{b}\.conv_dw\.weight$", rf"{fb}/conv_dw/kernel", _t_depthwise,
         "params"),
    ]
    rules += _conv_rules(rf"{b}\.se\.conv_reduce", rf"{fb}/se/conv_reduce")
    rules += _conv_rules(rf"{b}\.se\.conv_expand", rf"{fb}/se/conv_expand")
    rules += _conv_rules(rf"{b}\.conv_pwl", rf"{fb}/conv_pwl")
    for bn in ("bn1", "bn2", "bn3"):
        rules += _norm_rules(rf"{b}\.{bn}", rf"{fb}/{bn}")
    return rules


def satrn_rules(backbone: str = "efficientnetv2s") -> List[Rule]:
    """The SATRN family: the stem (LiteSATRN's ShallowCNN for
    ``backbone="shallow"``, else EfficientSATRN's EfficientNetV2 wrapper),
    the 2D PE, the SATRN encoder layers and the transformer decoder."""
    root = r"encoder\.shallow_cnn"
    rules: List[Rule] = []
    if backbone == "shallow":
        for i in range(4):
            rules += _conv_rules(rf"{root}\.conv{i}", f"encoder/shallow_cnn/conv{i}")
            rules += _norm_rules(rf"{root}\.batch_norm{i}", f"encoder/shallow_cnn/bn{i}")
    else:
        froot = "encoder/efficientnet"
        rules += _conv_rules(rf"{root}\.conv_stem", rf"{froot}/conv_stem")
        rules += _norm_rules(rf"{root}\.bn1", rf"{froot}/bn1")
        rules += _efficientnet_rules(rf"{root}\.eff_block", rf"{froot}/blocks")
        rules += _conv_rules(rf"{root}\.conv_last", rf"{froot}/conv_last")
        rules += _norm_rules(rf"{root}\.bn2", rf"{froot}/bn2")

    pe = r"encoder\.positional_encoding"
    rules += _linear_rules(rf"{pe}\.dense0", "encoder/positional_encoding/dense0")
    rules += _linear_rules(rf"{pe}\.dense1", "encoder/positional_encoding/dense1")

    el = r"encoder\.attention_layers\.(\d+)"
    fl = r"encoder/layer\1"
    rules += _ln_rules(rf"{el}\.norm", rf"{fl}/norm")
    rules += _mha_rules(rf"{el}\.attention_layer", rf"{fl}/attention")
    rules += _conv_rules(rf"{el}\.conv0", rf"{fl}/conv0")
    rules += _norm_rules(rf"{el}\.norm0", rf"{fl}/bn0")
    rules += [
        (rf"{el}\.depthwise\.weight$", rf"{fl}/depthwise/kernel",
         _t_depthwise, "params"),
        (rf"{el}\.depthwise\.bias$", rf"{fl}/depthwise/bias", _identity,
         "params"),
    ]
    rules += _norm_rules(rf"{el}\.depthwise_norm", rf"{fl}/bn_depth")
    rules += _conv_rules(rf"{el}\.conv1", rf"{fl}/conv1")
    rules += _norm_rules(rf"{el}\.norm1", rf"{fl}/bn1")

    rules += _transformer_decoder_rules()
    return rules


def swin_rules() -> List[Rule]:
    """SwinTRN: the Swin encoder (with its learned ``absolute_pos_embed``)
    and the transformer decoder with the sequential feed-forward. The
    reference's ``relative_position_index`` and ``attn_mask`` buffers and its
    unused head are "drop" rules: the modules drop them on load."""
    rules: List[Rule] = []
    rules += _conv_rules(r"encoder\.patch_embed\.proj", "encoder/patch_embed")
    rules += _ln_rules(r"encoder\.patch_embed\.norm", "encoder/patch_norm")
    rules += [(r"encoder\.absolute_pos_embed$", "encoder/absolute_pos_embed",
               _identity, "params")]
    blk = r"encoder\.layers\.(\d+)\.blocks\.(\d+)"
    fb = r"encoder/stage\1_block\2"
    rules += _ln_rules(rf"{blk}\.norm1", rf"{fb}/norm1")
    rules += _linear_rules(rf"{blk}\.attn\.qkv", rf"{fb}/attn/qkv")
    rules += _linear_rules(rf"{blk}\.attn\.proj", rf"{fb}/attn/proj")
    rules += [
        (rf"{blk}\.attn\.relative_position_bias_table$",
         rf"{fb}/attn/relative_position_bias_table", _identity, "params"),
        (rf"{blk}\.attn\.relative_position_index$", "", _identity, "drop"),
        (rf"{blk}\.attn_mask$", "", _identity, "drop"),
    ]
    rules += _ln_rules(rf"{blk}\.norm2", rf"{fb}/norm2")
    rules += _linear_rules(rf"{blk}\.mlp\.fc1", rf"{fb}/mlp_fc1")
    rules += _linear_rules(rf"{blk}\.mlp\.fc2", rf"{fb}/mlp_fc2")
    ds = r"encoder\.layers\.(\d+)\.downsample"
    rules += _ln_rules(rf"{ds}\.norm", r"encoder/stage\1_merge/norm")
    rules += [(rf"{ds}\.reduction\.weight$", r"encoder/stage\1_merge/reduction/kernel",
               _t_linear, "params")]
    rules += _ln_rules(r"encoder\.norm", "encoder/norm")
    rules += [
        (r"encoder\.head\..*$", "", _identity, "drop"),
        (r"encoder\.avgpool.*$", "", _identity, "drop"),
    ]
    rules += _transformer_decoder_rules(ff_naming="sequential")
    return rules


def aster_rules() -> List[Rule]:
    """EfficientASTER: DeepCNN (the V2-S blocks and the convRelu tail), the
    BiLSTM (torch ``l{k}[_reverse]`` -> ``l{k}_{fwd,bwd}/cell``), the
    projection, and the attention decoder."""
    rules: List[Rule] = []
    cnn = r"encoder\.cnn"
    f = "encoder/cnn"
    rules += _conv_rules(rf"{cnn}\.conv_stem", rf"{f}/conv_stem")
    rules += _norm_rules(rf"{cnn}\.bn1", rf"{f}/bn1")
    rules += _efficientnet_rules(rf"{cnn}\.eff_blocks", rf"{f}/blocks")
    # a conv2 stage the reference's forward never calls: dead weights
    rules += [(rf"{cnn}\.conv2\..*$", "", _identity, "drop")]
    rules += _conv_rules(rf"{cnn}\.conv1\.conv4", rf"{f}/conv1")
    rules += _norm_rules(rf"{cnn}\.conv1\.batchnorm4", rf"{f}/conv1_bn")
    rules += _conv_rules(rf"{cnn}\.conv3\.conv6", rf"{f}/conv3")
    rules += _norm_rules(rf"{cnn}\.conv3\.batchnorm6", rf"{f}/conv3_bn")
    for k in range(2):
        for suffix, d in (("", "fwd"), ("_reverse", "bwd")):
            for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                rules.append((rf"encoder\.blstm\.{w}_l{k}{suffix}$",
                              f"encoder/blstm/l{k}_{d}/cell/{w}", _identity, "params"))
    rules += _linear_rules(r"encoder\.proj", "encoder/proj")
    ac = r"decoder\.attention_cell"
    rules += [(r"decoder\.embedding\.weight$", "embedding/embedding", _identity,
               "params")]
    rules += _linear_rules(rf"{ac}\.i2h", "attention_cell/i2h")
    rules += _linear_rules(rf"{ac}\.h2h", "attention_cell/h2h")
    rules += _linear_rules(rf"{ac}\.score", "attention_cell/score")
    for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        rules.append((rf"{ac}\.rnn\.(\d+)\.{w}$", rf"attention_cell/cell\1/{w}",
                      _identity, "params"))
        # one-layer decoders keep a bare cell at .rnn
        rules.append((rf"{ac}\.rnn\.{w}$", rf"attention_cell/cell0/{w}", _identity,
                      "params"))
    rules += _linear_rules(r"decoder\.generator", "generator")
    return rules


def rules_for(network: str) -> List[Rule]:
    if network == "LiteSATRN":
        return satrn_rules("shallow")
    if network in ("EfficientSATRN", "MySATRN"):
        return satrn_rules()
    if network in ("SWIN", "SwinTRN"):
        return swin_rules()
    if network in ("EfficientASTER", "ASTER"):
        return aster_rules()
    raise NotImplementedError(network)


# ---------------------------------------------------------------------------
# inverse direction: flax trees -> reference-named state dict
# ---------------------------------------------------------------------------


def _invert_rule(pattern: str, template: str):
    """(torch_regex, flax_template) -> (flax_regex, backref_order).

    flax templates contain only literals and ``\\N`` backrefs into the
    torch pattern's ``(\\d+)`` groups; everything else in the rule tables
    is literal."""
    parts = re.split(r"(\\\d)", template)
    flax_pat = "^"
    order = []
    for p in parts:
        if re.fullmatch(r"\\\d", p):
            order.append(int(p[1]))
            flax_pat += r"(\d+)"
        else:
            flax_pat += re.escape(p)
    return re.compile(flax_pat + "$"), order


def _torch_key(pattern: str, groups: Dict[int, str]) -> str:
    """Fill the torch regex's ``(\\d+)`` groups with captured values and
    unescape the remaining literals."""
    counter = [0]

    def sub(_m):
        counter[0] += 1
        return groups[counter[0]]

    s = re.sub(r"\(\\d\+\)", sub, pattern.rstrip("$"))
    return re.sub(r"\\(.)", r"\1", s)


def _inverted_rules(network: str):
    """The network's rules, inverted: (flax regex, backref order, torch
    regex, inverse transform) for each non-"drop" rule."""
    inverted = []
    for pat, repl, transform, coll in rules_for(network):
        if coll == "drop" or not repl:
            continue
        flax_re, order = _invert_rule(pat, repl)
        inverted.append((flax_re, order, pat, _INV_TRANSFORM[transform]))
    return inverted


def _torch_route(path: str, inverted) -> Optional[Tuple[str, Callable]]:
    """A flax path -> (reference torch key, inverse transform), or None."""
    for flax_re, order, pat, inv in inverted:
        m = flax_re.match(path)
        if m:
            return _torch_key(pat, dict(zip(order, m.groups()))), inv
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in (tree or {}).items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def export_state_dict(
    network: str, params: Dict, batch_stats: Optional[Dict] = None
) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """flax (params, batch_stats) -> (reference-named numpy state dict,
    unmatched flax paths)."""
    inverted = _inverted_rules(network)
    flat = _flatten(params)
    flat.update(_flatten(batch_stats))
    sd: Dict[str, np.ndarray] = {}
    unmatched: List[str] = []
    for path, arr in flat.items():
        route = _torch_route(path, inverted)
        if route is None:
            unmatched.append(path)
        else:
            sd[route[0]] = route[1](arr)
    if network in ("EfficientASTER", "ASTER") and not any(
            k.startswith("decoder.attention_cell.rnn.1.") for k in sd):
        # one decoder layer: the reference's bare LSTMCell at .rnn
        sd = {k.replace("decoder.attention_cell.rnn.0.", "decoder.attention_cell.rnn."): v
              for k, v in sd.items()}
    return sd, unmatched


def state_dict_from_jax(network: str, params, batch_stats: Optional[Dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """Numpy (or array-like) ``params``/``batch_stats`` trees -> torch
    state dict. Raises if a JAX path has no rule."""
    sd, unmatched = export_state_dict(network, params, batch_stats or {})
    if unmatched:
        raise ValueError(f"{len(unmatched)} JAX paths have no rule: {unmatched[:8]}")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# forward direction: reference-named state dict -> flax trees
# ---------------------------------------------------------------------------


def _set_path(tree: Dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _match(rules: List[Rule], keys) -> Tuple[Dict[str, Tuple[str, str, Callable]], List[str]]:
    """Each torch key -> (collection, flax path, forward transform) by the
    first rule it matches ("drop" keys: collection "drop", no path), and
    the keys no rule matches."""
    compiled = [(re.compile(pat), repl, t, coll) for pat, repl, t, coll in rules]
    routes, unmatched = {}, []
    for key in keys:
        for pat, repl, transform, coll in compiled:
            if pat.match(key):
                routes[key] = (coll, pat.sub(repl, key) if coll != "drop" else "",
                               transform)
                break
        else:
            unmatched.append(key)
    return routes, unmatched


def _routes(network: str, keys) -> Dict[str, Tuple[str, str, Callable]]:
    """``_match`` by the network's rules; raises if a key has no rule."""
    routes, unmatched = _match(rules_for(network), keys)
    if unmatched:
        raise ValueError(f"{len(unmatched)} torch keys have no rule: {unmatched[:8]}")
    return routes


def flax_trees(network: str, state_dict: Dict[str, torch.Tensor]
               ) -> Tuple[Dict, Dict]:
    """A torch state dict -> the flax (``params``, ``batch_stats``) trees of
    the JAX model, numpy leaves, floating tensors as f32 (the JAX
    package's ``convert_state_dict``). Raises if a torch key has no rule."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, (coll, path, transform) in _routes(network, state_dict).items():
        if coll == "drop":
            continue
        value = state_dict[key].detach().cpu()
        arr = (value.float() if value.is_floating_point() else value).numpy()
        _set_path(trees[coll], path, transform(arr))
    return trees["params"], trees["batch_stats"]


def param_routes(network: str, named_parameters) -> Dict[str, Tuple[str, Callable, Callable]]:
    """Each trainable parameter's name -> (its flax path in ``params``, the
    forward transform, its inverse): the layout an optax state tree keeps
    the parameter's moments in. Raises if a parameter lands elsewhere."""
    names = [name for name, _ in named_parameters]
    routes = {}
    for name, (coll, path, transform) in _routes(network, names).items():
        if coll != "params":
            raise ValueError(f"parameter {name} has no place in the flax params tree")
        routes[name] = (path, transform, _INV_TRANSFORM[transform])
    return routes


# ---------------------------------------------------------------------------
# the pretrained-backbone bootstrap (``p4fr_tpu/utils/convert_pth.py``
# :412-683): timm's tf_efficientnetv2_s blocks and Microsoft's
# swin_base_patch4_window12_384_22k.pth, downloaded offline, converted by the
# JAX package's rules to its flax subtree and grafted into a freshly built
# model through the bridge's inverse, so that the two cannot drift
# ---------------------------------------------------------------------------

# a transform's effect on a shape (the graft checks shapes, not values)
_SHAPE = {
    _identity: lambda s: s,
    _t_linear: lambda s: s[::-1],
    _t_conv: lambda s: (s[2], s[3], s[1], s[0]),
    _t_depthwise: lambda s: (s[2], s[3], s[1], s[0]),
}


def _pattern_skeleton(pattern: str) -> str:
    """Regex rule pattern -> readable key template for diff hints."""
    s = pattern.rstrip("$").replace(r"\.", ".")
    s = re.sub(r"\(\\d\+\)", "N", s)
    return s.replace("\\", "")


def unmatched_report(rules: List[Rule], state_dict: Dict, unmatched: List[str]) -> str:
    """Each unmatched torch key with its shape and the closest rule
    templates."""
    import difflib

    skeletons = sorted({_pattern_skeleton(p) for p, _, _, _ in rules})
    lines = [f"{len(unmatched)} unmatched torch keys:"]
    for key in unmatched:
        shape = tuple(getattr(state_dict.get(key), "shape", ()))
        close = difflib.get_close_matches(key, skeletons, n=2, cutoff=0.4)
        lines.append(f"  {key} shape={shape}")
        lines.append(f"    nearest rule(s): {' | '.join(close) if close else '(no close rule)'}")
    lines.append(f"({len(state_dict) - len(unmatched)}/{len(state_dict)} keys matched; "
                 "fix the rule table or pass strict=False/--report to convert what "
                 "matched)")
    return "\n".join(lines)


def _load_torch_state_dict(src) -> Dict:
    """A path (``torch.load`` on the CPU, tensors only), a module or a state
    dict; a hub file's weights nested under ``model`` or ``state_dict`` are
    unwrapped."""
    if isinstance(src, str):
        src = torch.load(src, map_location="cpu", weights_only=True)
    if hasattr(src, "state_dict"):
        src = src.state_dict()
    for key in ("model", "state_dict"):
        if key in src and isinstance(src[key], dict) and any(
                hasattr(v, "shape") for v in src[key].values()):
            src = src[key]
            break
    return src


def _apply_rules(state_dict: Dict, rules: List[Rule]) -> Tuple[Dict, Dict, List[str]]:
    """A torch state dict -> (params, batch_stats, unmatched keys) by
    ``rules``, numpy leaves."""
    routes, unmatched = _match(rules, state_dict)
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, (coll, path, transform) in routes.items():
        if coll != "drop":
            value = state_dict[key]
            arr = np.asarray(value.detach().cpu().numpy() if hasattr(value, "detach")
                             else value)
            _set_path(trees[coll], path, transform(arr))
    return trees["params"], trees["batch_stats"], unmatched


def timm_efficientnetv2_rules() -> List[Rule]:
    """timm's ``tf_efficientnetv2_s*`` state dict -> the ``EfficientNetV2Blocks``
    subtree; timm's stem, head and classifier are dropped, as the
    reference keeps only ``m.blocks``."""
    rules = [(p, r.lstrip("/"), t, c) for p, r, t, c in _efficientnet_rules(r"blocks", "")]
    rules += [
        (r"conv_stem\..*$", "", _identity, "drop"),
        (r"bn1\..*$", "", _identity, "drop"),
        (r"conv_head\..*$", "", _identity, "drop"),
        (r"bn2\..*$", "", _identity, "drop"),
        (r"classifier\..*$", "", _identity, "drop"),
    ]
    return rules


def convert_timm_efficientnetv2(src, *, strict: bool = True):
    """timm EfficientNetV2-S weights (a path, a module or a state dict) ->
    (params, batch_stats, unmatched) of the ``blocks`` subtree."""
    state_dict = _load_torch_state_dict(src)
    rules = timm_efficientnetv2_rules()
    params, batch_stats, unmatched = _apply_rules(state_dict, rules)
    if unmatched and strict:
        raise ValueError("[convert_timm_efficientnetv2] "
                         + unmatched_report(rules, state_dict, unmatched))
    return params, batch_stats, unmatched


def swin_hub_rules() -> List[Rule]:
    """Microsoft's ``swin_base_patch4_window12_384_22k.pth`` (unprefixed
    ``patch_embed.*``, ``layers.*``, ``norm.*``) -> the Swin encoder's
    subtree; the head, the derived buffers and ``avgpool`` are dropped,
    and so is an ``absolute_pos_embed`` (the model keeps its own)."""
    rules: List[Rule] = []
    rules += _conv_rules(r"patch_embed\.proj", "patch_embed")
    rules += _ln_rules(r"patch_embed\.norm", "patch_norm")
    blk = r"layers\.(\d+)\.blocks\.(\d+)"
    fb = r"stage\1_block\2"
    rules += _ln_rules(rf"{blk}\.norm1", rf"{fb}/norm1")
    rules += _linear_rules(rf"{blk}\.attn\.qkv", rf"{fb}/attn/qkv")
    rules += _linear_rules(rf"{blk}\.attn\.proj", rf"{fb}/attn/proj")
    rules += [
        (rf"{blk}\.attn\.relative_position_bias_table$",
         rf"{fb}/attn/relative_position_bias_table", _identity, "params"),
        (rf"{blk}\.attn\.relative_position_index$", "", _identity, "drop"),
        (rf"{blk}\.attn_mask$", "", _identity, "drop"),
    ]
    rules += _ln_rules(rf"{blk}\.norm2", rf"{fb}/norm2")
    rules += _linear_rules(rf"{blk}\.mlp\.fc1", rf"{fb}/mlp_fc1")
    rules += _linear_rules(rf"{blk}\.mlp\.fc2", rf"{fb}/mlp_fc2")
    ds = r"layers\.(\d+)\.downsample"
    rules += _ln_rules(rf"{ds}\.norm", r"stage\1_merge/norm")
    rules += [(rf"{ds}\.reduction\.weight$", r"stage\1_merge/reduction/kernel",
               _t_linear, "params")]
    rules += _ln_rules(r"norm", "norm")
    rules += [
        (r"head\..*$", "", _identity, "drop"),
        (r"absolute_pos_embed$", "", _identity, "drop"),
        (r"avgpool.*$", "", _identity, "drop"),
    ]
    return rules


def convert_swin_hub(src, *, strict: bool = True):
    """Swin hub weights -> (params, batch_stats (always empty: Swin has no
    BatchNorm), unmatched) of the Swin encoder's subtree."""
    state_dict = _load_torch_state_dict(src)
    rules = swin_hub_rules()
    params, batch_stats, unmatched = _apply_rules(state_dict, rules)
    if unmatched and strict:
        raise ValueError("[convert_swin_hub] "
                         + unmatched_report(rules, state_dict, unmatched))
    return params, batch_stats, unmatched


# graft point of each family's pretrained backbone in the flax variables
_BACKBONE_PATHS = {
    "EfficientSATRN": ("encoder", "efficientnet", "blocks"),
    "MySATRN": ("encoder", "efficientnet", "blocks"),
    "EfficientASTER": ("encoder", "cnn", "blocks"),
    "ASTER": ("encoder", "cnn", "blocks"),
    "SWIN": ("encoder",),
    "SwinTRN": ("encoder",),
}


def pretrained_key_map(network: str, keys) -> Tuple[Dict[str, str], List[str], List[str]]:
    """The bootstrap's map of a hub or timm file's ``keys`` onto the
    ``network`` model's own -> ({file key: model key}, dropped keys,
    unmatched keys): file key -> the JAX rule -> flax path under the graft
    point -> the bridge's inverse."""
    swin = network in ("SWIN", "SwinTRN")
    routes, unmatched = _match(swin_hub_rules() if swin else timm_efficientnetv2_rules(),
                               keys)
    root = "/".join(_BACKBONE_PATHS[network])
    inverted = _inverted_rules(network)
    mapping: Dict[str, str] = {}
    dropped: List[str] = []
    for key, (coll, path, _) in routes.items():
        if coll == "drop":
            dropped.append(key)
            continue
        route = _torch_route(f"{root}/{path}", inverted)
        if route is None:
            unmatched.append(key)
        else:
            mapping[key] = route[0]
    return mapping, dropped, unmatched


def graft_backbone(model: torch.nn.Module, network: str, params: Dict,
                   batch_stats: Dict, path: Tuple[str, ...]) -> List[str]:
    """Copy converted pretrained weights into ``model`` in place, at the flax
    subtree ``path``, through the bridge's inverse -> the model keys
    written. Every leaf and shape of the subtree must match (the batch
    statistics too, when given), or it raises before it writes anything."""
    state = model.state_dict()
    leaves: Dict[str, Dict[str, tuple]] = {"params": {}, "batch_stats": {}}
    for key, (coll, flax_path, transform) in _routes(network, state).items():
        if coll != "drop":
            leaves[coll][flax_path] = tuple(_SHAPE[transform](tuple(state[key].shape)))
    root = "/".join(path)
    for coll, new in (("params", params), ("batch_stats", batch_stats)):
        if coll == "batch_stats" and not new:
            continue
        old = {p[len(root) + 1:]: shape for p, shape in leaves[coll].items()
               if p.startswith(root + "/")}
        if not old:
            raise KeyError(f"[graft_backbone] {coll}: no {root} in model variables")
        got = {p: tuple(a.shape) for p, a in _flatten(new).items()}
        if old != got:
            missing = sorted(set(old) - set(got))[:5]
            extra = sorted(set(got) - set(old))[:5]
            shapes = [f"{k}: {old[k]} != {got[k]}" for k in old
                      if k in got and old[k] != got[k]][:5]
            raise ValueError(f"[graft_backbone] {coll} mismatch at {root}: "
                             f"missing={missing} extra={extra} shapes={shapes}")
    trees = []
    for new in (params, batch_stats):
        tree: Dict = {}
        if new:
            _set_path(tree, root, new)
        trees.append(tree)
    sd, unmatched = export_state_dict(network, *trees)
    if unmatched:
        raise ValueError(f"[graft_backbone] {len(unmatched)} flax paths have no "
                         f"model key: {unmatched[:5]}")
    with torch.no_grad():
        for key, value in sd.items():
            state[key].copy_(torch.from_numpy(value))
    return sorted(sd)


def bootstrap_pretrained(model: torch.nn.Module, network: str, pretrained_cfg) -> List[str]:
    """Graft offline-downloaded public weights into a freshly built model,
    in place -> the model keys written. ``pretrained_cfg`` is a mapping
    with ``efficientnetv2`` (a timm tf_efficientnetv2_s .pth/.bin: the
    EfficientNet families) or ``swin`` (swin_base_patch4_window12_384_22k.pth:
    SwinTRN). A set but unusable value raises (a string, a network with no
    graft point, no entry for the network) rather than train from random
    weights. SwinTRN keeps its own ``absolute_pos_embed``, which the hub
    file lacks, as the reference's ``strict=False`` load does."""
    if not hasattr(pretrained_cfg, "get"):
        raise ValueError(
            "pretrained config must be a mapping with keys 'efficientnetv2' "
            f"and/or 'swin' (got {type(pretrained_cfg).__name__}: "
            f"{pretrained_cfg!r}); e.g. pretrained: {{efficientnetv2: /path/to/timm.pth}}")
    path = _BACKBONE_PATHS.get(network)
    if path is None:
        raise ValueError(
            f"network {network!r} has no pretrained-backbone graft point (known: "
            f"{sorted(_BACKBONE_PATHS)}); remove the 'pretrained' config entry")
    key = "swin" if network in ("SWIN", "SwinTRN") else "efficientnetv2"
    src = pretrained_cfg.get(key)
    if not src:
        raise ValueError(
            f"'pretrained' is set but has no {key!r} entry for network {network!r} "
            f"(got keys {sorted(pretrained_cfg.keys())})")
    if key == "swin":
        params, stats, _ = convert_swin_hub(src)
        own = model.state_dict().get("encoder.absolute_pos_embed")
        if own is not None and "absolute_pos_embed" not in params:
            params = dict(params, absolute_pos_embed=own.detach().float().cpu().numpy())
    else:
        params, stats, _ = convert_timm_efficientnetv2(src)
    return graft_backbone(model, network, params, stats, path)
