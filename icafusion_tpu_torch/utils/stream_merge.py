"""Stream merging: run the two towers' first layer pairs as one module each.

The counterpart of the JAX package's utils/stream_merge.py, over the port's
state dicts (OIHW kernels). The RGB and IR towers run as two module chains
(reference yolo_test.py:140-156: layer s reads the IR image through -4).
Merging concatenates the two streams on the channel axis and replaces each
pair (layer i, layer s + i), i < k, by one module ``m{i}_{s+i}`` whose
kernels are block-diagonal scatters of the two streams' kernels, and whose
per-channel vectors (BatchNorm, conv biases) are the two streams'
concatenated. The zero blocks add exact zeros, so the outputs equal the
unmerged model's up to the order of float sums.

C3's ``cv3`` reads the concat [m branch | cv2 branch], which in a merged C3
interleaves the streams as [A_m | B_m | A_2 | B_2]: its kernel's input rows
are placed to match (``_interleave_rows``). SPPF's and SPP's ``cv2`` read an
n-segment pool concat and are placed the same way.

On the TPU the merge fills the 128 lanes XLA pads the 64-channel stages to;
on the H100 it doubles the merged stages' multiply-adds and recovers no
padding, so ``resolve_merge("auto", cfg)`` is 0 in the port and an explicit
count merges exactly as the JAX package does:

    model = merged_model(model, 3)           # or build_model(cfg,
                                             #   merge_pairs=3) + the state
    state = merge_stream_state(cfg, model.state_dict(), 3)

int8 composes by merging first, then calibrating and quantizing the merged
model (the merged input's per-channel absmax is the streams' concatenated).

Training on the merged graph takes one addition: the zero blocks receive
non-zero weight gradients (each stream's activations meet the other's
output error in the shared conv), so the gradients of the merged modules
are multiplied by ``grad_mask`` before the optimizer. The zero blocks then
stay exactly 0 through momentum, weight decay and EMA, and
``unmerge_train_state`` gives back the standard layout without loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

MERGEABLE = ("Conv", "C3", "VGGblock", "ResNetlayer", "SPPF", "SPP")
# where (c1, c2) sit in each mergeable module's resolved args
_CH_ARGS = {"Conv": (0, 1), "C3": (0, 1), "VGGblock": (1, 2),
            "ResNetlayer": (0, 1), "SPPF": (0, 1), "SPP": (0, 1)}
_QUANT_LEAVES = ("w8", "s_w", "s_in")

State = Dict[str, torch.Tensor]


def ir_stream_start(resolved) -> int:
    """Index of the IR tower's first layer (the one fed by -4)."""
    for r in resolved:
        if r.f == -4:
            return r.i
    raise ValueError("not a two-stream model: no layer takes the -4 input")


def validate_merge(resolved, pairs: int) -> int:
    """Check that layers 0..pairs-1 pair up with s..s+pairs-1; return s."""
    s = ir_stream_start(resolved)
    if not 0 < pairs <= s:
        raise ValueError(f"merge_pairs must be in 1..{s} for this graph")
    for i in range(pairs):
        a, b = resolved[i], resolved[s + i]
        if a.module not in MERGEABLE:
            raise ValueError(f"layer {i} ({a.module}) is not stream-mergeable "
                             f"(supported: {MERGEABLE})")
        if (a.module, a.args, a.n) != (b.module, b.args, b.n):
            raise ValueError(f"layers {i} and {s+i} differ: "
                             f"{a.module}{a.args} vs {b.module}{b.args}")
        if b.f not in (-1, -4) or (i > 0 and a.f != -1):
            raise ValueError(f"merged layers must form plain chains; layer "
                             f"{s+i} has from={b.f}")
        if a.module == "Conv" and len(a.args) > 5 and a.args[5] != 1:
            raise ValueError("grouped Conv cannot be stream-merged")
        if a.module == "C3" and len(a.args) > 4:
            raise ValueError(
                "C3 with explicit g/e args cannot be stream-merged (the cv3 "
                "row permutation assumes the default hidden width c2*0.5)")
    if pairs < s and resolved[s + pairs].f != -1:
        raise ValueError(f"layer {s+pairs} must chain on the previous layer")
    return s


def _min_internal_width(r) -> int:
    """Narrowest channel count any conv inside the layer sees."""
    if r.module == "C3":
        return min(r.args[0], r.args[1], int(r.args[1] * 0.5))
    if r.module in ("SPPF", "SPP"):
        return min(r.args[0] // 2, r.args[1])
    if r.module == "VGGblock":
        return min(r.args[1], r.args[2])
    if r.module == "ResNetlayer":
        return r.args[1] if r.args[3] else min(r.args[0], r.args[1])
    return min(r.args[0], r.args[1])  # Conv


def auto_merge_pairs(cfg, lane_width: int = 128) -> int:
    """The JAX package's choice: the longest prefix of mergeable layer pairs
    whose narrowest internal conv is under the TPU's 128 lanes (yolov5l 3,
    s 5, n 7; VGG16 and ResNet50 2; 0 for a single-stream graph)."""
    from icafusion_tpu_torch.models.assembler import resolve_model

    resolved, _ = resolve_model(cfg)
    try:
        s = ir_stream_start(resolved)
    except ValueError:
        return 0
    k = 0
    while k < s:
        a, b = resolved[k], resolved[s + k]
        if (a.module not in MERGEABLE
                or (a.module, a.args, a.n) != (b.module, b.args, b.n)
                or _min_internal_width(a) >= lane_width
                or (a.module == "Conv" and len(a.args) > 5
                    and a.args[5] != 1)):
            break
        k += 1
    # the layer after the merged block must chain on it (validate_merge)
    while k and k < s and resolved[s + k].f != -1:
        k -= 1
    return k


def resolve_merge(spec, cfg) -> int:
    """A --merge / merge_streams value: an int or a numeric string merges
    that many pairs (validated against ``cfg``); 0, None and "auto" merge
    none. "auto" is the JAX package's lane rule (auto_merge_pairs), which
    recovers nothing on the H100, so the port keeps it at 0."""
    if spec is None or str(spec).strip().lower() in ("auto", "", "0"):
        return 0
    k = int(spec)
    if k:
        from icafusion_tpu_torch.models.assembler import resolve_model
        validate_merge(resolve_model(cfg)[0], k)
    return k


def merged_args(module: str, args: Tuple) -> Tuple:
    """Double the module's two channel args (positions in _CH_ARGS)."""
    i, j = _CH_ARGS[module]
    a = list(args)
    a[i], a[j] = 2 * a[i], 2 * a[j]
    return tuple(a)


# ---------------------------------------------------------------------------
# state transforms
# ---------------------------------------------------------------------------

def _interleave_rows(c_: int, n_seg: int):
    """Merged input rows of the conv after a concat of n_seg per-stream
    segments, each c_ wide: the merged concat is [A0|B0|A1|B1|...], so
    stream A's rows sit at 2k*c_ and B's at 2k*c_ + c_."""
    rows_a = np.concatenate([np.arange(c_) + 2 * k * c_
                             for k in range(n_seg)])
    return rows_a, rows_a + c_


def _spp_segments(r) -> int:
    if r.module == "SPPF":
        return 4
    ks = r.args[2] if len(r.args) > 2 else (5, 9, 13)
    return len(ks) + 1


def _row_plan(r):
    """(child name, rows_a, rows_b) for the one child of layer r whose
    kernel rows are interleaved, or None."""
    if r.module == "C3":
        # e fixed at the reference default 0.5 (validate_merge)
        return ("cv3",) + _interleave_rows(int(r.args[1] * 0.5), 2)
    if r.module in ("SPPF", "SPP"):
        return ("cv2",) + _interleave_rows(r.args[0] // 2, _spp_segments(r))
    return None


def _rows_for(rest: str, plan):
    if plan is not None and rest.split(".", 1)[0] == plan[0]:
        return plan[1], plan[2]
    return None, None


def _merge_leaf(a: torch.Tensor, b: torch.Tensor, rows_a, rows_b
                ) -> torch.Tensor:
    """A 4-D (O, I, kh, kw) kernel becomes the block scatter (A's into its
    rows and the first O_a outputs, B's into the rest); a vector is
    concatenated; a 0-d counter keeps A's."""
    if a.dim() == 4:
        co_a, ci_a = a.shape[:2]
        co_b, ci_b = b.shape[:2]
        ra = (torch.arange(ci_a) if rows_a is None
              else torch.as_tensor(rows_a))
        rb = (ci_a + torch.arange(ci_b) if rows_b is None
              else torch.as_tensor(rows_b))
        k = a.new_zeros((co_a + co_b, ci_a + ci_b) + tuple(a.shape[2:]))
        k[:co_a, ra.to(a.device)] = a
        k[co_a:, rb.to(a.device)] = b
        return k
    if a.dim() == 0:
        return a.clone()
    return torch.cat([a, b], 0)


def _split_leaf(m: torch.Tensor, rows_a, rows_b):
    """The inverse of _merge_leaf: the two streams' tensors."""
    if m.dim() == 4:
        co, ci = m.shape[0] // 2, m.shape[1] // 2
        ra = torch.arange(ci) if rows_a is None else torch.as_tensor(rows_a)
        rb = (ci + torch.arange(ci) if rows_b is None
              else torch.as_tensor(rows_b))
        return (m[:co, ra.to(m.device)].contiguous(),
                m[co:, rb.to(m.device)].contiguous())
    if m.dim() == 0:
        return m.clone(), m.clone()
    c = m.shape[0] // 2
    return m[:c].clone(), m[c:].clone()


def _by_prefix(state: Mapping[str, torch.Tensor], prefix: str):
    p = prefix + "."
    return {k[len(p):]: v for k, v in state.items() if k.startswith(p)}


def merge_stream_state(cfg, state: Mapping[str, torch.Tensor],
                       pairs: int) -> State:
    """The state dict of build_model(cfg, merge_pairs=pairs) from one of
    build_model(cfg): every m{i}.* and m{s+i}.* replaced by m{i}_{s+i}.*.
    Works on any mapping keyed by state-dict names (a model's state dict,
    its parameters, optimizer buffers, an EMA tree); tensors stay on their
    device. A quantized state raises: merge first, then quantize."""
    from icafusion_tpu_torch.models.assembler import resolve_model

    resolved, _ = resolve_model(cfg)
    s = validate_merge(resolved, pairs)
    if any(k.rsplit(".", 1)[-1] in _QUANT_LEAVES for k in state):
        raise ValueError(
            "merge before adding the 'quant' collection (quantize the "
            "merged model: its calib absmax is the concat of the streams')")
    out = dict(state)
    for i in range(pairs):
        a, b = _by_prefix(state, f"m{i}"), _by_prefix(state, f"m{s+i}")
        if not a and not b:
            continue        # the mapping does not cover these layers
        if a.keys() != b.keys():
            raise KeyError(f"m{i} and m{s+i} hold different tensors")
        plan = _row_plan(resolved[i])
        for rest in a:
            del out[f"m{i}.{rest}"], out[f"m{s+i}.{rest}"]
            out[f"m{i}_{s+i}.{rest}"] = _merge_leaf(
                a[rest], b[rest], *_rows_for(rest, plan))
    return out


def unmerge_stream_state(cfg, state: Mapping[str, torch.Tensor],
                         pairs: int) -> State:
    """The inverse of merge_stream_state: m{i}_{s+i}.* sliced back into
    m{i}.* and m{s+i}.*, bit for bit (the standard layout a checkpoint
    keeps)."""
    from icafusion_tpu_torch.models.assembler import resolve_model

    resolved, _ = resolve_model(cfg)
    s = validate_merge(resolved, pairs)
    out = dict(state)
    for i in range(pairs):
        m = _by_prefix(state, f"m{i}_{s+i}")
        plan = _row_plan(resolved[i])
        for rest, t in m.items():
            del out[f"m{i}_{s+i}.{rest}"]
            out[f"m{i}.{rest}"], out[f"m{s+i}.{rest}"] = _split_leaf(
                t, *_rows_for(rest, plan))
    return out


def _rebuilt(model, state: State, pairs: int, device=None):
    """A model of ``model``'s config with ``pairs`` merged pairs (0: none),
    holding ``state``, on ``device`` (default ``model``'s) and in
    ``model``'s mode."""
    from icafusion_tpu_torch.models.assembler import build_model
    out = build_model(model.cfg, merge_pairs=pairs)
    out.load_state_dict(state)
    return out.to(device or next(model.parameters()).device).train(
        model.training)


def merged_model(model, pairs: int):
    """The stream-merged twin of an unmerged float model (its weights
    merged; ``model`` is left as it is)."""
    if model.merge_pairs:
        raise ValueError("the model is already stream-merged")
    return _rebuilt(model, merge_stream_state(model.cfg, model.state_dict(),
                                              pairs), pairs)


def unmerged_model(model):
    """The standard-layout twin of a stream-merged model."""
    return _rebuilt(model, unmerge_stream_state(
        model.cfg, model.state_dict(), model.merge_pairs), 0)


def _transform_trainer(trainer, pairs: int, fn, to_pairs: int, device):
    """A Trainer over fn(the model), with fn applied to every tensor map of
    the state (the optimizer's momentum, or Adam's m and v, and the EMA
    shadow) and its counters and key carried over. The zero blocks of the
    momentum and the EMA are exactly 0 under the gradient mask, so both
    directions are lossless."""
    cfg = trainer.model.cfg
    device = device or trainer.device
    model = _rebuilt(trainer.model, fn(cfg, trainer.model.state_dict(),
                                       pairs), to_pairs, device)
    new = dataclasses.replace(trainer, model=model, device=device)

    def moved(tree):
        return {k: v.to(new.device) for k, v in fn(cfg, tree, pairs).items()}

    mom = trainer.opt.momentum
    new.opt.momentum = ({k: moved(mom[k]) for k in ("m", "v")}
                        if trainer.adam else moved(mom))
    new.opt.step = trainer.opt.step
    new.ema.tree = moved(trainer.ema.tree)
    new.ema.updates = trainer.ema.updates
    new.rng = np.array(trainer.rng, np.uint32)
    new.reseed()
    return new


def merge_train_state(cfg, trainer, pairs: int):
    """A Trainer on the merged graph from a standard-layout one (train its
    steps with make_train_step(grad_mask=grad_mask(...)))."""
    if trainer.model.merge_pairs:
        raise ValueError("the trainer's model is already stream-merged")
    return _transform_trainer(trainer, pairs, merge_stream_state, pairs,
                              None)


def unmerge_train_state(cfg, trainer, pairs: int, device=None):
    """The standard-layout Trainer of a merged one (on ``device``, default
    the trainer's): checkpoints keep the standard layout, so resuming,
    export and conversion never see merged names."""
    return _transform_trainer(trainer, pairs, unmerge_stream_state, 0,
                              device)


def grad_mask(cfg, params: Mapping[str, torch.Tensor], pairs: int) -> State:
    """0/1 masks (float32, on each tensor's device) for the tensors of the
    merged modules m{i}_{s+i}.* in ``params``: 1 on the block-diagonal
    support of each merged kernel, 0 on its zero blocks; the other tensors
    carry no mask. Trainer.make_train_step multiplies these gradients."""
    from icafusion_tpu_torch.models.assembler import resolve_model

    s = validate_merge(resolve_model(cfg)[0], pairs)
    prefixes = tuple(f"m{i}_{s+i}." for i in range(pairs))
    ones = {k: torch.ones_like(v, dtype=torch.float32)
            for k, v in params.items() if k.startswith(prefixes)}
    return merge_stream_state(cfg, unmerge_stream_state(cfg, ones, pairs),
                              pairs)
