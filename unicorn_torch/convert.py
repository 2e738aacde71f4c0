"""Weight bridge: a flax parameter tree of the JAX package -> a state_dict
with the reference torch model's names, which the port's modules use
(`from_flax`), and back (`to_flax`, for comparing gradients).

The name table is a copy of tools/convert_torch_weights.py `build_rules`
(reference torch name regex -> flax path), which maps torch -> flax. Here
each rule is inverted: its flax template becomes a regex over flax paths and
its torch regex a template, and each transform is undone:

  flax conv kernel (kh, kw, I, O) -> torch (O, I, kh, kw)
  flax dw kernel   (kh, kw, 1, C) -> torch (C, 1, kh, kw)
  flax Dense       (I, O)         -> torch (O, I)
  head beta        (C,)           -> torch (1, C, 1, 1)

The tool has no rules for the CSPDarknet backbone or for the "conv" and
"full" interaction modes; this table adds them under the reference's torch
names (YOLOX darknet.py `stem`, `dark2`...`dark5`; Conv_Inter `conv1`,
`norm`, `conv2`; the DETR-style encoder's nn.MultiheadAttention). That
attention keeps the query, key and value projections in one tensor
(`in_proj_weight`, rows [q; k; v]) where flax keeps three leaves, so those
leaves are joined and split outside the one-leaf rules.

The ResNet-50 and Swin trunks have no rules in the tool either. Theirs here
use torchvision's ResNet names (conv1, bn1, layer{s}.{i}.{conv,bn}{1-3},
layer{s}.{i}.downsample.{0,1}; flax numbers BottleneckRes_k flat across the
stages) and the public Swin release's (patch_embed.{proj,norm},
layers.{i}.blocks.{j}.*, layers.{i}.downsample.{norm,reduction}, norm{i}).
These names were not checked against a reference checkpoint, and a public
Swin checkpoint's downsample.norm / reduction would need their 4C axis
permuted: the JAX model merges the 2x2 neighbours in another order
(unicorn_torch/models/swin.py). Swin's output norms share the name norm{i}
with ConvNeXt's; `to_flax` tells the trunks apart by their other tensors.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# heads of the "full" interaction's attention (FullAttentionInteraction)
FULL_NHEAD = 8
_QKV = ("query", "key", "value")
_QKV_FLAX = re.compile(r"interaction/layer(\d+)/MultiHeadDotProductAttention_0"
                       r"/(query|key|value)/(kernel|bias)$")
_QKV_TORCH = re.compile(r"transformer\.encoder\.layers\.(\d+)\.self_attn"
                        r"\.in_proj_(weight|bias)$")
_SWIN_TORCH = re.compile(r"backbone\.backbone\.(patch_embed|layers)\.")


def t_conv(w):
    return np.transpose(w, (2, 3, 1, 0))


def t_linear(w):
    return np.transpose(w, (1, 0))


def t_beta(w):
    return w.reshape(-1)


def t_attn_out(w):
    """nn.MultiheadAttention out_proj (C, H*D) -> flax out kernel (H, D,
    C)."""
    return np.transpose(w, (1, 0)).reshape(FULL_NHEAD, -1, w.shape[0])


# the inverse of each torch -> flax transform
INVERSE = {
    t_conv: lambda w: np.transpose(w, (3, 2, 0, 1)),
    t_linear: lambda w: np.transpose(w, (1, 0)),
    t_beta: lambda w: w.reshape(1, -1, 1, 1),
    t_attn_out: lambda w: np.transpose(w.reshape(-1, w.shape[-1]), (1, 0)),
    None: lambda w: w,
}


def map_base_conv(dst, prefix):
    """Reference BaseConv '<p>.conv.weight' + '<p>.bn.{weight,bias}'."""
    return {
        "conv.weight": (f"{dst}/Conv_0/kernel", t_conv),
        "bn.weight": (f"{dst}/GroupNorm32_0/GroupNorm_0/scale", None),
        "bn.bias": (f"{dst}/GroupNorm32_0/GroupNorm_0/bias", None),
    }


def map_csp(dst):
    """Reference CSPLayer: conv1..conv3 and the bottlenecks m.<i>, for any
    number of them (the index is a regex group)."""
    out = {}
    for src_c, dst_c in (("conv1", "BaseConv_0"), ("conv2", "BaseConv_1"),
                         ("conv3", "BaseConv_2")):
        for k, v in map_base_conv(f"{dst}/{dst_c}", "").items():
            out[f"{src_c}.{k}"] = v
    for src_c, dst_c in (("conv1", "BaseConv_0"), ("conv2", "BaseConv_1")):
        for k, v in map_base_conv(f"{dst}/Bottleneck_\\1/{dst_c}",
                                  "").items():
            out[f"m.(\\d+).{src_c}.{k}"] = v
    return out


def map_convnext_block(dst):
    return {
        "dwconv.weight": (f"{dst}/Conv_0/kernel", t_conv),
        "dwconv.bias": (f"{dst}/Conv_0/bias", None),
        "norm.weight": (f"{dst}/LayerNorm_0/scale", None),
        "norm.bias": (f"{dst}/LayerNorm_0/bias", None),
        "pwconv1.weight": (f"{dst}/Dense_0/kernel", t_linear),
        "pwconv1.bias": (f"{dst}/Dense_0/bias", None),
        "pwconv2.weight": (f"{dst}/Dense_1/kernel", t_linear),
        "pwconv2.bias": (f"{dst}/Dense_1/bias", None),
        "gamma": (f"{dst}/gamma", None),
    }


def convnext_block_params(tree) -> dict:
    """The flax sub-tree of one ConvNeXtBlock (Conv_0, LayerNorm_0, Dense_0,
    Dense_1, gamma) -> the parameter dict of ops.convnext_block under the
    port's names (dwconv, norm, pwconv1, pwconv2, gamma), fp32 tensors in
    the torch layouts."""
    p: dict = {}
    for name, (path, tf) in map_convnext_block("").items():
        node = tree
        for part in path.strip("/").split("/"):
            node = node[part]
        *parents, leaf = name.split(".")
        d = p
        for part in parents:
            d = d.setdefault(part, {})
        d[leaf] = torch.tensor(INVERSE[tf](np.asarray(node, np.float32)))
    return p


def convnext_block_params_to_flax(p) -> dict:
    """The inverse of convnext_block_params: fp32 numpy arrays under the
    flax names and in the flax layouts."""
    tree: dict = {}
    for name, (path, tf) in map_convnext_block("").items():
        t = p
        for part in name.split("."):
            t = t[part]
        w = t.detach().float().cpu().numpy()
        *parents, leaf = path.strip("/").split("/")
        d = tree
        for part in parents:
            d = d.setdefault(part, {})
        d[leaf] = tf(w) if tf is not None else w
    return tree


RESNET50_LAYERS = (3, 4, 6, 3)
SWIN_BLOCK = (("norm1.weight", "norm1/scale", None),
              ("norm1.bias", "norm1/bias", None),
              ("attn.qkv.weight", "attn/qkv/kernel", t_linear),
              ("attn.qkv.bias", "attn/qkv/bias", None),
              ("attn.proj.weight", "attn/proj/kernel", t_linear),
              ("attn.proj.bias", "attn/proj/bias", None),
              ("attn.relative_position_bias_table",
               "attn/relative_position_bias_table", None),
              ("norm2.weight", "norm2/scale", None),
              ("norm2.bias", "norm2/bias", None),
              ("mlp.fc1.weight", "fc1/kernel", t_linear),
              ("mlp.fc1.bias", "fc1/bias", None),
              ("mlp.fc2.weight", "fc2/kernel", t_linear),
              ("mlp.fc2.bias", "fc2/bias", None))


def map_resnet(dst, layers=RESNET50_LAYERS):
    """torchvision ResNet names -> (flax path under dst, transform), for
    stages of `layers` blocks (flax numbers the blocks flat)."""
    def gn(path):
        return {"weight": (f"{path}/GroupNorm_0/scale", None),
                "bias": (f"{path}/GroupNorm_0/bias", None)}

    out = {"conv1.weight": (f"{dst}/Conv_0/kernel", t_conv)}
    out.update({f"bn1.{k}": v for k, v in gn(f"{dst}/GroupNorm32_0").items()})
    k = 0
    for s, n in enumerate(layers):
        for i in range(n):
            src, blk = f"layer{s + 1}.{i}", f"{dst}/BottleneckRes_{k}"
            convs = [(f"conv{j + 1}", f"bn{j + 1}", j) for j in range(3)]
            if i == 0:
                convs.append(("downsample.0", "downsample.1", 3))
            for conv, norm, j in convs:
                out[f"{src}.{conv}.weight"] = (f"{blk}/Conv_{j}/kernel",
                                               t_conv)
                out.update({f"{src}.{norm}.{p}": v for p, v in
                            gn(f"{blk}/GroupNorm32_{j}").items()})
            k += 1
    return out


def build_rules(swin: bool = False):
    """Returns list of (regex, dst_template, transform) rules. The trunk's
    output norms (norm{i}) are Swin's with `swin`, else ConvNeXt's."""
    rules = []

    def add(pat, dst, tf=None):
        rules.append((re.compile(pat + "$"), dst, tf))

    # --- ConvNeXt backbone ---
    bb = "backbone/ConvNeXt_0"
    add(r"backbone\.backbone\.downsample_layers\.0\.0\.weight",
        f"{bb}/stem_conv/kernel", t_conv)
    add(r"backbone\.backbone\.downsample_layers\.0\.0\.bias",
        f"{bb}/stem_conv/bias")
    add(r"backbone\.backbone\.downsample_layers\.0\.1\.weight",
        f"{bb}/stem_norm/scale")
    add(r"backbone\.backbone\.downsample_layers\.0\.1\.bias",
        f"{bb}/stem_norm/bias")
    add(r"backbone\.backbone\.downsample_layers\.(\d+)\.0\.weight",
        f"{bb}/down_norm\\1/scale")
    add(r"backbone\.backbone\.downsample_layers\.(\d+)\.0\.bias",
        f"{bb}/down_norm\\1/bias")
    add(r"backbone\.backbone\.downsample_layers\.(\d+)\.1\.weight",
        f"{bb}/down_conv\\1/kernel", t_conv)
    add(r"backbone\.backbone\.downsample_layers\.(\d+)\.1\.bias",
        f"{bb}/down_conv\\1/bias")
    for src, (dst, tf) in [
        (k, v) for k, v in map_convnext_block(
            f"{bb}/stage\\1_block\\2").items()
    ]:
        add(r"backbone\.backbone\.stages\.(\d+)\.(\d+)\." +
            src.replace(".", r"\."), dst, tf)
    sw = "backbone/SwinTransformer_0"
    out_norm = sw if swin else bb
    add(r"backbone\.backbone\.norm(\d+)\.weight",
        f"{out_norm}/out_norm\\1/scale")
    add(r"backbone\.backbone\.norm(\d+)\.bias", f"{out_norm}/out_norm\\1/bias")

    # --- Swin (the public release's names) ---
    pe = r"backbone\.backbone\.patch_embed\."
    add(pe + r"proj\.weight", f"{sw}/patch_embed/kernel", t_conv)
    add(pe + r"proj\.bias", f"{sw}/patch_embed/bias")
    add(pe + r"norm\.weight", f"{sw}/patch_norm/scale")
    add(pe + r"norm\.bias", f"{sw}/patch_norm/bias")
    for src, dst, tf in SWIN_BLOCK:
        add(r"backbone\.backbone\.layers\.(\d+)\.blocks\.(\d+)\."
            + src.replace(".", r"\."), f"{sw}/stage\\1_block\\2/{dst}", tf)
    add(r"backbone\.backbone\.layers\.(\d+)\.downsample\.norm\.weight",
        f"{sw}/merge_norm\\1/scale")
    add(r"backbone\.backbone\.layers\.(\d+)\.downsample\.norm\.bias",
        f"{sw}/merge_norm\\1/bias")
    add(r"backbone\.backbone\.layers\.(\d+)\.downsample\.reduction\.weight",
        f"{sw}/merge_reduce\\1/kernel", t_linear)

    # --- ResNet-50 (torchvision's names) ---
    for src, (dst, tf) in map_resnet("backbone/ResNet50_0").items():
        add(r"backbone\.backbone\." + src.replace(".", r"\."), dst, tf)

    # --- CSPDarknet backbone (flax names its stages' modules in order) ---
    cd, tb = "backbone/CSPDarknet_0", r"backbone\.backbone\."

    def add_module(src, mapping):
        for s_, (d_, tf) in mapping.items():
            add(tb + src + r"\." + s_.replace(".", r"\."), d_, tf)

    add_module(r"stem\.conv", map_base_conv(f"{cd}/stem/BaseConv_0", ""))
    for j in range(4):
        add_module(rf"dark{j + 2}\.0", map_base_conv(f"{cd}/BaseConv_{j}", ""))
        add_module(rf"dark{j + 2}\.{2 if j == 3 else 1}",
                   map_csp(f"{cd}/CSPLayer_{j}"))
    for src_c, dst_c in (("conv1", "BaseConv_0"), ("conv2", "BaseConv_1")):
        add_module(rf"dark5\.1\.{src_c}",
                   map_base_conv(f"{cd}/SPPBottleneck_0/{dst_c}", ""))

    # --- PAFPN ---
    for name in ("lateral_conv0", "reduce_conv1", "bu_conv1", "bu_conv2",
                 "adjust0", "adjust1", "adjust2"):
        for src, (dst, tf) in map_base_conv(f"backbone/{name}", "").items():
            add(rf"backbone\.{name}\." + src.replace(".", r"\."), dst, tf)
    for csp in ("C3_p4", "C3_p3", "C3_n3", "C3_n4"):
        for src, (dst, tf) in map_csp(f"backbone/{csp}").items():
            add(rf"backbone\.{csp}\." + src.replace(".", r"\."), dst, tf)

    # --- head ---
    for src, (dst, tf) in map_base_conv("head/stem\\1", "").items():
        add(r"head\.stems\.(\d+)\." + src.replace(".", r"\."), dst, tf)
    for tower, dst_t in (("cls_convs", "cls_conv"), ("reg_convs", "reg_conv")):
        for src, (dst, tf) in map_base_conv(f"head/{dst_t}\\1_\\2", "").items():
            add(rf"head\.{tower}\.(\d+)\.(\d+)\." + src.replace(".", r"\."),
                dst, tf)
    for pred, dst_p in (("cls_preds", "cls_pred"), ("reg_preds", "reg_pred"),
                        ("obj_preds", "obj_pred"),
                        ("cls_preds_sot", "cls_pred_sot"),
                        ("reg_preds_sot", "reg_pred_sot"),
                        ("obj_preds_sot", "obj_pred_sot"),
                        ("controllers", "controller")):
        add(rf"head\.{pred}\.(\d+)\.weight", f"head/{dst_p}\\1/Conv_0/kernel",
            t_conv)
        add(rf"head\.{pred}\.(\d+)\.bias", f"head/{dst_p}\\1/Conv_0/bias")
    for src, (dst, tf) in map_convnext_block("head/att\\1_\\2").items():
        add(r"head\.att_layers\.(\d+)\.(\d+)\." + src.replace(".", r"\."),
            dst, tf)
    add(r"head\.beta_(\d+)", "head/beta_\\1", t_beta)

    # --- bottleneck / upsample / pos emb / deformable transformer ---
    add(r"bottleneck\.0\.weight", "bottleneck/Conv_0/kernel", t_conv)
    add(r"bottleneck\.0\.bias", "bottleneck/Conv_0/bias")
    add(r"bottleneck\.1\.weight", "bottleneck/GroupNorm_0/scale")
    add(r"bottleneck\.1\.bias", "bottleneck/GroupNorm_0/bias")
    add(r"upsample_layer\.1\.weight", "upsample/Conv_0/kernel", t_conv)
    add(r"upsample_layer\.1\.bias", "upsample/Conv_0/bias")
    add(r"upsample_layer\.3\.weight", "upsample/Conv_1/kernel", t_conv)
    add(r"upsample_layer\.3\.bias", "upsample/Conv_1/bias")
    add(r"pos_emb\.row_embed\.weight", "pos_emb/row_embed")
    add(r"pos_emb\.col_embed\.weight", "pos_emb/col_embed")
    add(r"transformer\.level_embed", "interaction/level_embed")
    for src, dst in (("sampling_offsets", "sampling_offsets"),
                     ("attention_weights", "attention_weights"),
                     ("value_proj", "value_proj"),
                     ("output_proj", "output_proj")):
        add(rf"transformer\.encoder\.layers\.(\d+)\.self_attn\.{src}\.weight",
            f"interaction/layer\\1/{dst}/kernel", t_linear)
        add(rf"transformer\.encoder\.layers\.(\d+)\.self_attn\.{src}\.bias",
            f"interaction/layer\\1/{dst}/bias")
    add(r"transformer\.encoder\.layers\.(\d+)\.norm1\.weight",
        "interaction/layer\\1/LayerNorm_0/scale")
    add(r"transformer\.encoder\.layers\.(\d+)\.norm1\.bias",
        "interaction/layer\\1/LayerNorm_0/bias")
    add(r"transformer\.encoder\.layers\.(\d+)\.linear1\.weight",
        "interaction/layer\\1/Dense_0/kernel", t_linear)
    add(r"transformer\.encoder\.layers\.(\d+)\.linear1\.bias",
        "interaction/layer\\1/Dense_0/bias")
    add(r"transformer\.encoder\.layers\.(\d+)\.linear2\.weight",
        "interaction/layer\\1/Dense_1/kernel", t_linear)
    add(r"transformer\.encoder\.layers\.(\d+)\.linear2\.bias",
        "interaction/layer\\1/Dense_1/bias")
    add(r"transformer\.encoder\.layers\.(\d+)\.norm2\.weight",
        "interaction/layer\\1/LayerNorm_1/scale")
    add(r"transformer\.encoder\.layers\.(\d+)\.norm2\.bias",
        "interaction/layer\\1/LayerNorm_1/bias")
    # "full": the attention's output projection (in_proj: see _QKV_FLAX)
    add(r"transformer\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.weight",
        "interaction/layer\\1/MultiHeadDotProductAttention_0/out/kernel",
        t_attn_out)
    add(r"transformer\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.bias",
        "interaction/layer\\1/MultiHeadDotProductAttention_0/out/bias")
    # "conv"
    add(r"transformer\.conv1\.weight", "interaction/conv1/kernel", t_conv)
    add(r"transformer\.norm\.weight",
        "interaction/norm/GroupNorm_0/scale")
    add(r"transformer\.norm\.bias", "interaction/norm/GroupNorm_0/bias")
    add(r"transformer\.conv2\.weight", "interaction/conv2/kernel", t_conv)
    add(r"transformer\.conv2\.bias", "interaction/conv2/bias")

    # --- CondInst mask branch ---
    for name, dst_name, n in (("refine", "refine", 3), ("tower", "tower", 4)):
        for i in range(n):
            add(rf"head\.mask_branch\.{name}\.{i}\.0\.weight",
                f"mask_branch/{dst_name}{i}/Conv_0/kernel", t_conv)
            add(rf"head\.mask_branch\.{name}\.{i}\.1\.weight",
                f"mask_branch/{dst_name}{i}/GroupNorm32_0/GroupNorm_0/scale")
            add(rf"head\.mask_branch\.{name}\.{i}\.1\.bias",
                f"mask_branch/{dst_name}{i}/GroupNorm32_0/GroupNorm_0/bias")
    add(r"head\.mask_branch\.tower\.4\.weight", "mask_branch/tower_out/kernel",
        t_conv)
    add(r"head\.mask_branch\.tower\.4\.bias", "mask_branch/tower_out/bias")
    add(r"head\.mask_branch\.up_mask_layer\.0\.weight",
        "mask_branch/up_mask_conv1/kernel", t_conv)
    add(r"head\.mask_branch\.up_mask_layer\.0\.bias",
        "mask_branch/up_mask_conv1/bias")
    add(r"head\.mask_branch\.up_mask_layer\.2\.weight",
        "mask_branch/up_mask_conv2/kernel", t_conv)
    add(r"head\.mask_branch\.up_mask_layer\.2\.bias",
        "mask_branch/up_mask_conv2/bias")
    for i in range(2):
        add(rf"head\.mask_branch\.seg_head\.{i}\.0\.weight",
            f"mask_branch/seg_head{i}/Conv_0/kernel", t_conv)
        add(rf"head\.mask_branch\.seg_head\.{i}\.1\.weight",
            f"mask_branch/seg_head{i}/GroupNorm32_0/GroupNorm_0/scale")
        add(rf"head\.mask_branch\.seg_head\.{i}\.1\.bias",
            f"mask_branch/seg_head{i}/GroupNorm32_0/GroupNorm_0/bias")
    add(r"head\.mask_branch\.logits\.weight", "mask_branch/seg_logits/kernel",
        t_conv)
    add(r"head\.mask_branch\.logits\.bias", "mask_branch/seg_logits/bias")
    return rules


def _inverse_rules(swin: bool = False):
    """(flax path regex, torch name template, inverse transform) per rule."""
    inv = []
    for pat, dst, tf in build_rules(swin):
        flax_re = re.compile(re.escape(dst).replace(r"\\1", r"(\d+)")
                             .replace(r"\\2", r"(\d+)") + "$")
        groups = iter(range(1, 10))
        torch_t = re.sub(r"\(\\d\+\)", lambda m: f"\\{next(groups)}",
                         pat.pattern[:-1]).replace("\\.", ".")
        inv.append((flax_re, torch_t, INVERSE[tf]))
    return inv


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield "/".join(prefix + (str(k),)), v


def from_flax(params):
    """flax params tree (the variables dict or its "params") -> state_dict
    of fp32 torch tensors under the reference's names. A leaf that no rule
    names raises."""
    if set(params) == {"params"}:
        params = params["params"]
    rules = _inverse_rules("SwinTransformer_0" in params.get("backbone", {}))
    state, qkv = {}, {}
    for path, leaf in _flatten(params):
        w = np.asarray(leaf, np.float32)
        m = _QKV_FLAX.match(path)
        if m:
            # kernel (C, H, D) -> rows (H*D, C); bias (H, D) -> (H*D,)
            part = (np.transpose(w.reshape(w.shape[0], -1), (1, 0))
                    if m.group(3) == "kernel" else w.reshape(-1))
            kind = "weight" if m.group(3) == "kernel" else "bias"
            name = (f"transformer.encoder.layers.{m.group(1)}.self_attn."
                    f"in_proj_{kind}")
            qkv.setdefault(name, {})[_QKV.index(m.group(2))] = part
            continue
        for flax_re, torch_t, inv in rules:
            m = flax_re.match(path)
            if m:
                state[m.expand(torch_t)] = torch.tensor(inv(w))
                break
        else:
            raise KeyError(f"from_flax: no rule names the flax leaf {path!r}")
    for name, parts in qkv.items():
        state[name] = torch.tensor(np.concatenate([parts[i]
                                                   for i in range(3)]))
    return state


def to_flax(named_tensors):
    """The inverse of from_flax: a dict of tensors under the state_dict's
    names (parameters, or their gradients) -> a nested dict of fp32 numpy
    arrays under the flax paths and in the flax layouts, so that a gradient
    can be compared with the JAX package's leaf by leaf. A name that no rule
    matches raises. The trunk's output norms go to Swin's leaves when a
    Swin tensor (patch_embed.*, layers.*) is among the names."""
    rules = build_rules(any(_SWIN_TORCH.match(n) for n in named_tensors))
    tree = {}

    def put(path, w):
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = w

    for name, t in named_tensors.items():
        w = t.detach().float().cpu().numpy()
        m = _QKV_TORCH.match(name)
        if m:
            att = (f"interaction/layer{m.group(1)}/"
                   "MultiHeadDotProductAttention_0")
            for which, part in zip(_QKV, np.split(w, 3)):
                if m.group(2) == "weight":   # rows (H*D, C) -> (C, H, D)
                    part = np.transpose(part, (1, 0)).reshape(
                        part.shape[1], FULL_NHEAD, -1)
                    put(f"{att}/{which}/kernel", part)
                else:
                    put(f"{att}/{which}/bias", part.reshape(FULL_NHEAD, -1))
            continue
        for pat, dst, tf in rules:
            m = pat.match(name)
            if m:
                put(m.expand(dst), tf(w) if tf is not None else w)
                break
        else:
            raise KeyError(f"to_flax: no rule names the tensor {name!r}")
    return tree
