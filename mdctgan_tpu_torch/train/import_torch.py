"""The reference's ``.pth`` checkpoints <-> the port's ``state_dict``.

The reference publishes its generator as a torch ``state_dict`` whose keys
are ``nn.Sequential`` indices (``model.14.weight``), because pix2pixHD
builds every net as a Sequential.  The port of
``mdctgan_tpu/train/import_torch.py``: the mapping from those keys to the
port's names (the Flax tree paths joined with dots, as in ``weights.py``) is
data, made by replaying the reference's construction order for one
architecture.  Both sides are PyTorch, so the tensors carry over as they
are: a Conv2d weight (O, I, kH, kW), a ConvTranspose2d weight (I, O, kH, kW),
BatchNorm weight, bias and running statistics, the positional embeddings.

The tables cover every branch the JAX package maps, including local
attention and ``n_local_enhancers > 1``, which the port's generator does not
build yet.  ``import_generator`` runs the reference's fallback ladder on the
module's own initial values, which in torch are concrete: strict, then
without the excess keys, then ``--param_key_map`` renames, then the module's
own values for what is still missing or of another size.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

# Entry: (torch_prefix, flax_path, kind); kind in conv | convT | bn | posemb
Entry = Tuple[str, Tuple[str, ...], str]

_LEAVES = {"conv": ("weight", "bias"), "convT": ("weight", "bias"),
           "bn": ("weight", "bias", "running_mean", "running_var"),
           "posemb": ("height", "width")}

# ---------------------------------------------------------------------------
# the tables (replay the reference's construction order)
# ---------------------------------------------------------------------------


class _Seq:
    """Index assignment of an ``nn.Sequential``."""

    def __init__(self, torch_name: str):
        self.name = torch_name
        self.idx = 0
        self.entries: List[Entry] = []

    def skip(self, n: int = 1) -> None:  # pads, norms, activations
        self.idx += n

    def here(self) -> str:
        return f"{self.name}.{self.idx}"

    def add(self, kind: str, flax_path: Tuple[str, ...], sub: str = "") -> None:
        prefix = self.here() + (f".{sub}" if sub else "")
        self.entries.append((prefix, flax_path, kind))

    def conv(self, flax_path: Tuple[str, ...]) -> None:
        self.add("conv", flax_path)
        self.idx += 1

    def module(self, emit) -> None:
        """The entries of a composite module at one index."""
        emit(self.here(), self.entries)
        self.idx += 1


def _conv_resblock(prefix: str, path: Tuple[str, ...], out: List[Entry]) -> None:
    out.append((f"{prefix}.conv1", path + ("conv1", "conv"), "conv"))
    out.append((f"{prefix}.conv2", path + ("conv2", "conv"), "conv"))
    out.append((f"{prefix}.conv_res", path + ("conv_res", "conv"), "conv"))


# InterpolateUpsample has the same three conv attribute names
_interp_upsample = _conv_resblock


def _resnet_block(prefix: str, path: Tuple[str, ...], out: List[Entry]) -> None:
    # conv_block: 0 pad, 1 conv, 2 norm, 3 act, 4 pad, 5 conv, 6 norm
    out.append((f"{prefix}.conv_block.1", path + ("conv1", "conv"), "conv"))
    out.append((f"{prefix}.conv_block.5", path + ("conv2", "conv"), "conv"))


def _bottle_stack(prefix: str, path: Tuple[str, ...], num_layers: int,
                  first_has_shortcut: bool, out: List[Entry]) -> None:
    """BottleStack.net: a Sequential of BottleBlocks; each block.net: 0 conv,
    1 bn, 2 act, 3 attn, 4 pool/id, 5 bn, 6 act, 7 conv, 8 bn; the optional
    shortcut: 0 conv, 1 bn, 2 act."""
    for layer in range(num_layers):
        b = f"{prefix}.net.{layer}"
        p = path + (f"block{layer}",)
        if layer == 0 and first_has_shortcut:
            out.append((f"{b}.shortcut.0", p + ("shortcut_conv",), "conv"))
            out.append((f"{b}.shortcut.1", p + ("shortcut_bn", "bn"), "bn"))
        out.append((f"{b}.net.0", p + ("proj_in",), "conv"))
        out.append((f"{b}.net.1", p + ("bn1", "bn"), "bn"))
        out.append((f"{b}.net.3.to_qkv", p + ("attn", "to_qkv"), "conv"))
        out.append((f"{b}.net.3.pos_emb", p + ("attn", "pos_emb"), "posemb"))
        out.append((f"{b}.net.5", p + ("bn2", "bn"), "bn"))
        out.append((f"{b}.net.7", p + ("proj_out",), "conv"))
        out.append((f"{b}.net.8", p + ("bn3", "bn"), "bn"))


def _down_layer(seq: _Seq, kind: str, path: Tuple[str, ...]) -> None:
    if kind == "conv":
        seq.add("conv", path + ("conv",))
        seq.idx += 1
    else:  # resconv
        seq.module(lambda pfx, out: _conv_resblock(pfx, path, out))
    seq.skip(2)  # norm, relu


def _up_layer(seq: _Seq, kind: str, path: Tuple[str, ...]) -> None:
    if kind == "transconv":
        seq.add("convT", path + ("conv",))
        seq.idx += 1
    else:  # interpolate
        seq.module(lambda pfx, out: _interp_upsample(pfx, path, out))
    seq.skip(2)  # norm, relu


def global_generator_entries(
    torch_name: str,
    flax_prefix: Tuple[str, ...],
    n_downsampling: int,
    n_blocks: int,
    n_attn: int,
    downsample_type: str,
    upsample_type: str,
    include_head: bool,
) -> List[Entry]:
    """The reference's GlobalGenerator construction order."""
    seq = _Seq(torch_name)
    seq.skip(1)  # ReflectionPad2d(3)
    seq.conv(flax_prefix + ("stem", "conv"))
    seq.skip(2)  # norm, relu
    for i in range(n_downsampling):
        _down_layer(seq, "conv" if downsample_type == "conv" else "resconv",
                    flax_prefix + (f"down{i}",))
    mid = n_blocks // 2
    for i in range(n_blocks + (1 if n_attn > 0 else 0)):
        # bottleneck order: res0..res(mid-1), attn, res(mid)..res(n-1)
        if n_attn > 0 and i == mid:
            seq.module(lambda pfx, out: _bottle_stack(
                pfx, flax_prefix + ("attn",), n_attn, False, out))
        else:
            r = i if (n_attn == 0 or i < mid) else i - 1
            seq.module(lambda pfx, out, r=r: _resnet_block(
                pfx, flax_prefix + (f"res{r}",), out))
    for i in range(n_downsampling):
        _up_layer(seq, upsample_type, flax_prefix + (f"up{i}",))
    if include_head:
        seq.skip(1)  # pad
        seq.conv(flax_prefix + ("head", "conv"))
        seq.skip(1)  # tanh
    return seq.entries


def local_enhancer_entries(
    n_downsample_global: int,
    n_blocks_global: int,
    n_attn_global: int,
    n_blocks_local: int,
    n_attn_local: int,
    downsample_type: str,
    upsample_type: str,
    n_local_enhancers: int = 1,
) -> List[Entry]:
    """The reference's LocalEnhancer construction order: ``model`` is the
    truncated global, ``model{n}_1`` the branch-n stem, ``model{n}_2`` the
    branch-n refine/upsample stack (the head on the last branch only)."""
    entries = global_generator_entries(
        "model", ("global",), n_downsample_global, n_blocks_global, n_attn_global,
        downsample_type, upsample_type, include_head=False)
    for n in range(1, n_local_enhancers + 1):
        p = "" if n == n_local_enhancers else f"enh{n}_"
        with_head = n == n_local_enhancers

        # model{n}_1: pad, conv7, norm, relu, down, norm, relu
        seq = _Seq(f"model{n}_1")
        seq.skip(1)
        seq.conv((f"{p}local_stem", "conv"))
        seq.skip(2)
        if downsample_type == "conv":
            seq.add("conv", (f"{p}local_down", "conv"))
            seq.idx += 1
        else:
            seq.module(lambda pfx, out: _conv_resblock(pfx, (f"{p}local_down",), out))
        seq.skip(2)
        entries += seq.entries

        # model{n}_2: resblocks (+ [down-seq, attn] in the middle and 3 shared
        # ups after), the upsample[, pad, conv7, tanh on the last branch]
        seq = _Seq(f"model{n}_2")
        mid = n_blocks_local // 2

        def emit_attn(seq: _Seq, p: str = p) -> None:
            # the inserted down stack is one Sequential at one index:
            # [down0, norm, relu, shared, norm, relu, shared, norm, relu]
            sub = _Seq(seq.here())
            if downsample_type == "conv":
                sub.add("conv", (f"{p}local_attn_down0", "conv"))
                sub.idx += 1
            else:
                sub.module(lambda q, o: _conv_resblock(q, (f"{p}local_attn_down0",), o))
            sub.skip(2)
            # one module registered twice: its tensors appear under both
            # indices, both mapped onto the one module
            for _ in range(2):
                if downsample_type == "conv":
                    sub.add("conv", (f"{p}local_attn_down_shared", "conv"))
                    sub.idx += 1
                else:
                    sub.module(lambda q, o: _conv_resblock(
                        q, (f"{p}local_attn_down_shared",), o))
                sub.skip(2)
            seq.entries.extend(sub.entries)
            seq.idx += 1
            # attention: dim ngf_l != dim_out 2*ngf_l -> a shortcut
            seq.module(lambda pfx2, out: _bottle_stack(
                pfx2, (f"{p}local_attn",), n_attn_local, True, out))

        for i in range(n_blocks_local):
            if n_attn_local > 0 and i == mid:
                emit_attn(seq)
            seq.module(lambda pfx2, out, i=i: _resnet_block(
                pfx2, (f"{p}local_res{i}",), out))
        if n_blocks_local == 0 and n_attn_local > 0:
            emit_attn(seq)  # the list-insert places it with no resblocks too
        if n_attn_local > 0:
            # one upsample registered three times, mapped onto one module
            for _ in range(3):
                _up_layer(seq, upsample_type, (f"{p}local_attn_up_shared",))
        _up_layer(seq, upsample_type, (f"{p}local_up",))
        if with_head:
            seq.skip(1)
            seq.conv((f"{p}local_head", "conv"))
            seq.skip(1)
        entries += seq.entries
    return entries


def discriminator_entries(num_d: int, n_layers: int) -> List[Entry]:
    """MultiscaleDiscriminator with intermediate features: per scale i,
    groups ``scale{i}_layer{j}``, the conv at sub-index 0."""
    return [(f"scale{i}_layer{j}.0", (f"scale{i}", f"layer{j}", "conv"), "conv")
            for i in range(num_d) for j in range(n_layers + 2)]


def generator_entries_for(gen: nn.Module) -> List[Entry]:
    """The table for one of the port's generators."""
    from mdctgan_tpu_torch.models.generator import GlobalGenerator, LocalEnhancer

    if isinstance(gen, LocalEnhancer):
        return local_enhancer_entries(
            gen.n_downsample_global, gen.n_blocks_global, gen.n_attn_global,
            gen.n_blocks_local, gen.n_attn_local, gen.downsample_type,
            gen.upsample_type, gen.n_local_enhancers)
    if isinstance(gen, GlobalGenerator):
        return global_generator_entries(
            "model", (), gen.n_downsampling, gen.n_blocks, gen.n_attn,
            gen.downsample_type, gen.upsample_type, gen.include_head)
    raise TypeError(f"unsupported generator {type(gen)}")


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def _port_key(path: Tuple[str, ...], leaf: str) -> str:
    return ".".join(path + (leaf,))


def expected_torch_keys(entries: List[Entry]) -> Tuple[List[str], List[str]]:
    """The reference keys a table implies: ``(required, optional)``.
    Optional: conv biases (the attention's 1x1 convs have none) and the BN
    ``num_batches_tracked`` counters."""
    req: List[str] = []
    opt: List[str] = []
    for prefix, _path, kind in entries:
        if kind in ("conv", "convT"):
            req.append(f"{prefix}.weight")
            opt.append(f"{prefix}.bias")
        elif kind == "bn":
            req += [f"{prefix}.{leaf}" for leaf in _LEAVES["bn"]]
            opt.append(f"{prefix}.num_batches_tracked")
        elif kind == "posemb":
            req += [f"{prefix}.height", f"{prefix}.width"]
        else:
            raise ValueError(kind)
    return req, opt


def _torch_shapes(entries: List[Entry],
                  shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, Tuple[int, ...]]:
    """The reference's shape of each reference key a table implies, from the
    port's shapes by port key (``module.state_dict()``'s, which may live on
    the meta device): both sides are PyTorch layouts, so they carry over.
    A leaf the module lacks (a bias-free conv's bias) is left out."""
    out: Dict[str, Tuple[int, ...]] = {}
    for prefix, path, kind in entries:
        for leaf in _LEAVES[kind]:
            port = _port_key(path, leaf)
            if port in shapes:
                out[f"{prefix}.{leaf}"] = tuple(shapes[port])
    return out


def convert_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    entries: List[Entry],
    expected_shapes: Optional[Mapping[str, Tuple[int, ...]]] = None,
) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Reference ``state_dict`` -> (port tensors by port key, unconsumed
    reference keys, missing required reference keys).  A required key that
    is absent, or whose tensor's shape differs from ``expected_shapes`` (by
    port key), is missing and its tensor stays unconsumed."""
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    missing: List[str] = []
    for prefix, path, kind in entries:
        if kind not in _LEAVES:
            raise ValueError(kind)
        for leaf in _LEAVES[kind]:
            key, port = f"{prefix}.{leaf}", _port_key(path, leaf)
            t = state_dict.get(key)
            if t is not None and expected_shapes is not None and port in expected_shapes \
                    and tuple(t.shape) != tuple(expected_shapes[port]):
                t = None  # size mismatch: leave it unconsumed
            if t is None:
                if not (leaf == "bias" and kind in ("conv", "convT")):
                    missing.append(key)
                continue
            consumed.add(key)
            out[port] = t.detach().to("cpu", torch.float32, copy=True)
        if kind == "bn" and f"{prefix}.num_batches_tracked" in state_dict:
            consumed.add(f"{prefix}.num_batches_tracked")  # discarded
    leftover = [k for k in state_dict if k not in consumed]
    return out, leftover, missing


def apply_param_key_map(
    state_dict: Mapping[str, torch.Tensor],
    key_map: Mapping[str, str],
    consumed_ok: set,
) -> Dict[str, torch.Tensor]:
    """The reference's ``--param_key_map`` module renames: for a key whose
    first two components ``a.b`` are in the map, ``b`` becomes
    ``map["a.b"]``.  Only keys that did not load (missing from the model or
    of another size) are renamed."""
    if not key_map:
        return dict(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        parts = name.split(".")
        if name not in consumed_ok and len(parts) >= 2:
            key = parts[0] + "." + parts[1]
            if key in key_map:
                parts[1] = key_map[key]
                new = ".".join(parts)
                print(f"    {name} -> {new}")
                out[new] = value
                continue
        out[name] = value
    return out


def _fuzzy_import(
    state_dict: Mapping[str, torch.Tensor],
    entries: List[Entry],
    what: str,
    param_key_map: Optional[Mapping[str, str]],
    module: nn.Module,
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A strict load, then the reference's fallback ladder: drop the excess
    keys; rename by ``param_key_map``; keep ``module``'s own values for
    what is still missing or of another size (printing the size-matched
    candidates).  Returns the port ``state_dict`` (every key of
    ``module.state_dict()``) and the rungs taken, in order, among
    ``"excess_keys"``, ``"param_key_map"`` and ``"kept_init"``."""
    own = module.state_dict()
    shapes = {k: tuple(v.shape) for k, v in own.items()}
    rungs: List[str] = []
    converted, leftover, missing = convert_state_dict(state_dict, entries, shapes)
    if missing and param_key_map:
        req, opt_keys = expected_torch_keys(entries)
        consumed_ok = (set(req) | set(opt_keys)) - set(missing)
        renamed = apply_param_key_map(state_dict, param_key_map, consumed_ok)
        if set(renamed) != set(state_dict):
            rungs.append("param_key_map")
        state_dict = renamed
        converted, leftover, missing = convert_state_dict(state_dict, entries, shapes)
    unknown = sorted(set(converted) - set(own))
    if unknown:
        raise KeyError(f"{what}: the table maps onto names the module lacks: {unknown[:8]}")
    if leftover:
        rungs.insert(0, "excess_keys")
    if missing:
        print(f"Pretrained network {what} has fewer layers; "
              "The following layers are possibly matched:")
        by_shape: Dict[Tuple[int, ...], List[str]] = {}
        for k in leftover:
            by_shape.setdefault(tuple(state_dict[k].shape), []).append(k)
        port_of = {f"{prefix}.{leaf}": _port_key(path, leaf)
                   for prefix, path, kind in entries for leaf in _LEAVES[kind]}
        for name in missing:
            for cand in by_shape.get(shapes.get(port_of[name]), []):
                print(f"     {name} : {cand}")
    absent = [k for k in own if k not in converted]
    if absent:
        if not missing:
            print(f"Pretrained network {what}: keeping init values for "
                  f"{len(absent)} param(s) the checkpoint does not carry "
                  f"(e.g. {absent[0]})")
        rungs.append("kept_init")
    if not missing and leftover:
        print(f"Pretrained network {what} has excessive layers; "
              "Only loading layers that are used")
    return {k: converted[k] if k in converted else v.detach() for k, v in own.items()}, rungs


def import_generator(
    state_dict: Mapping[str, torch.Tensor],
    gen: nn.Module,
    *,
    param_key_map: Optional[Mapping[str, str]] = None,
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Reference generator ``state_dict`` -> (a ``state_dict`` that ``gen``
    loads strictly, the fallback rungs taken; ``[]`` for a strict load).
    What the checkpoint does not carry keeps ``gen``'s current values, so
    initialise ``gen`` first (``weights.init_weights``)."""
    return _fuzzy_import(state_dict, generator_entries_for(gen), "G", param_key_map, gen)


def import_discriminator(
    state_dict: Mapping[str, torch.Tensor],
    disc: nn.Module,
    num_d: int,
    n_layers: int,
    *,
    param_key_map: Optional[Mapping[str, str]] = None,
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``import_generator`` for a ``MultiscaleDiscriminator``."""
    return _fuzzy_import(state_dict, discriminator_entries(num_d, n_layers), "D",
                         param_key_map, disc)


def export_to_torch_keys(state_dict: Mapping[str, torch.Tensor],
                         entries: List[Entry]) -> Dict[str, torch.Tensor]:
    """A port ``state_dict`` -> the reference's keys (the inverse map; a
    conv without bias writes no bias)."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, path, kind in entries:
        for leaf in _LEAVES[kind]:
            port = _port_key(path, leaf)
            if port in state_dict:
                out[f"{prefix}.{leaf}"] = state_dict[port].detach().cpu().contiguous()
            elif not (leaf == "bias" and kind in ("conv", "convT")):
                raise KeyError(f"{port} (for {prefix}.{leaf}) is not in the state_dict")
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)
