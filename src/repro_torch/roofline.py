"""Roofline analysis of the LM stack's cells (counterpart: `repro/roofline.py`),
with an NVIDIA H100's figures.

Hardware model (H100 SXM at its 700 W limit; NVIDIA's data sheet, dense
rates without sparsity):
    peak bf16 tensor-core compute  989 TFLOP/s   (PEAK_FLOPS)
    peak float32 off the tensor cores  67 TFLOP/s (PEAK_FLOPS_FP32)
    HBM bandwidth                  3.35 TB/s     (HBM_BW)
    NVLink, each way               450 GB/s      (LINK_BW)

Three terms per (arch x shape x mesh), in seconds:
    compute    = FLOPs / (chips * peak)
    memory     = HBM bytes / (chips * hbm_bw)
    collective = collective bytes per chip / link_bw

The LM cells' products are bf16 and take PEAK_FLOPS; the dry run's `--kde`
record, whose work is float32 off the tensor cores, takes PEAK_FLOPS_FP32
(`terms(..., peak=)`).  NVLink joins the 8 cards of one host all to all; a
16 x 16 mesh spans 32 such hosts, whose links between hosts are slower, so
the collective term is a lower bound.  A card set below 700 W runs slower
than these peaks.

`model_flops`, `hbm_bytes` and `kv_cache_bytes` are the reference's
arithmetic on the config, copied as they are.  Where the reference parses
the compiled HLO (`HloCostModel`), the port traces a step:
`TraceCostModel` is a dispatch mode that sees every op one device runs
(for a DTensor op, the local ops its dispatch runs on that device's
shards, not the global op) and counts
  * dot FLOPs per device: mm / bmm / addmm / baddbmm, which `einsum` and
    `matmul` lower to, by `torch.utils.flop_counter`'s formulas;
  * every op's FLOPs that those formulas know (`flops_all`);
  * collective bytes per device by kind, the bytes of each collective's
    result as the reference counts them ("all-reduce", "all-gather",
    "reduce-scatter", "all-to-all", and send / recv as
    "collective-permute");
  * the peak of the bytes of live tensors that ops made during the trace
    (the storages of the tensors registered as arguments are not counted).
Eager mode runs every iteration, so no trip count is needed, except for the
SSM families' loops over time, which the dry run traces one step of
(`one_step_scans=True`, read by `models.layers.time_scan`): `scaled(steps)` multiplies what ops count
inside it, and the backward nodes they made, by the trip count.  Memory
is not scaled: the per-step tensors a real loop keeps for its backward are
counted once.

`torch.utils.flop_counter.FlopCounterMode` counts a DTensor op at its
global shape (and may also count the local op its dispatch runs), so it
does not give per-device FLOPs; the trace here counts local ops only.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

PEAK_FLOPS = 989e12
PEAK_FLOPS_FP32 = 67e12
HBM_BW = 3.35e12
LINK_BW = 450e9

_aten = torch.ops.aten
DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}

# collective ops -> (the reference's kind, which tensor is the result: "out"
# for a functional op's output, or the index of an in-place op's argument)
_COLLECTIVES = {}


def _collectives() -> dict:
    if not _COLLECTIVES:
        f, c = torch.ops._c10d_functional, torch.ops.c10d
        _COLLECTIVES.update({
            f.all_reduce: ("all-reduce", "out"), f.all_reduce_: ("all-reduce", "out"),
            f.all_gather_into_tensor: ("all-gather", "out"),
            f.reduce_scatter_tensor: ("reduce-scatter", "out"),
            f.all_to_all_single: ("all-to-all", "out"),
            c.allreduce_: ("all-reduce", 0), c.allgather_: ("all-gather", 0),
            c._allgather_base_: ("all-gather", 0), c.reduce_scatter_: ("reduce-scatter", 0),
            c._reduce_scatter_base_: ("reduce-scatter", 0), c.alltoall_: ("all-to-all", 0),
            c.alltoall_base_: ("all-to-all", 0), c.send: ("collective-permute", 0),
            c.recv_: ("collective-permute", 0), c.broadcast_: ("all-reduce", 0),
        })
    return _COLLECTIVES


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


class TraceCostModel(TorchDispatchMode):
    """Counts what one device runs while the context is on (see the module
    docstring): `dot_flops`, `flops_all`, `collective_bytes()`,
    `peak_bytes`.  `one_step_scans`: `models.layers.time_scan` runs one
    step and scales it while this mode is on."""

    def __init__(self, one_step_scans: bool = False):
        super().__init__()
        self.one_step_scans = one_step_scans
        self.dot_flops = 0.0
        self.flops_all = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()
        self._scale = 1
        self._propagating = 0

    # -- arguments and memory ------------------------------------------------
    def register_args(self, tree) -> int:
        """Mark the storages of the tensors in `tree` (DTensors by their
        local shards) as arguments: not counted.  Returns their bytes."""
        total = 0
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._seen:
                    self._seen[st] = 0
                    total += st.nbytes()
        return total

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    # -- scaling of one-step scans -------------------------------------------
    @contextlib.contextmanager
    def scaled(self, steps: int):
        """What runs inside counts `steps` times.  Yields `mark(outputs)`,
        which tags the autograd nodes made inside behind `outputs` to count
        `steps` times in the backward too (by autograd sequence number)."""
        with torch.enable_grad():
            start = (torch.zeros((), requires_grad=True) * 1).grad_fn._sequence_nr()

        def mark(outputs) -> None:
            todo = [t.grad_fn for t in tree_leaves(outputs)
                    if isinstance(t, torch.Tensor) and t.grad_fn is not None]
            seen = set()
            while todo:
                node = todo.pop()
                if node is None or id(node) in seen or node._sequence_nr() <= start:
                    continue
                seen.add(id(node))
                node.metadata["trace_scale"] = steps
                todo.extend(n for n, _ in node.next_functions)

        outer, self._scale = self._scale, self._scale * steps
        try:
            yield mark
        finally:
            self._scale = outer

    def _multiplier(self) -> int:
        node = torch._C._current_autograd_node()
        tagged = node.metadata.get("trace_scale", 1) if node is not None else 1
        return max(self._scale, tagged)

    # -- DTensor's shape propagation -----------------------------------------
    def __enter__(self):
        """While the trace is on, DTensor's shape propagation (which runs
        the op at its global shape on fake tensors, on a cache miss) is
        marked, and what it runs is neither counted nor tracked."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        model = self

        def marked(*args, **kwargs):
            model._propagating += 1
            try:
                return prop(*args, **kwargs)
            finally:
                model._propagating -= 1

        self._saved_prop = prop
        self._propagating = 0
        ShardingPropagator._propagate_tensor_meta_non_cached = marked
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._saved_prop
        return super().__exit__(*exc)

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in flat):
            # DTensor's dispatch runs next, with this mode still on: the
            # local ops it runs on this device's shards come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        packet = func._overloadpacket
        m = self._multiplier()
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops_all += m * n
            if packet in DOTS:
                self.dot_flops += m * n
        kind = _collectives().get(packet)
        if kind is not None:
            name, which = kind
            self.coll[name] += m * _nbytes(out if which == "out" else args[which])
        self._track(out)
        return out

    def collective_bytes(self):
        """(total bytes per device, {kind: bytes})."""
        by_kind = {k: v for k, v in self.coll.items() if v}
        return float(sum(by_kind.values())), by_kind


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS + HBM-byte accounting (the reference's arithmetic)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape, n_layers_attn_quadratic: bool = True) -> float:
    """6*N*D train / 2*N*D per-token decode, + attention score FLOPs."""
    N_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * N_active * tokens
        flops += _attn_flops(cfg, B, S, causal=True) * 3.0   # fwd + 2x bwd
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * N_active * tokens
        flops += _attn_flops(cfg, B, S, causal=True)
    else:  # decode: one token against an S-long context
        flops = 2.0 * N_active * B
        flops += _attn_decode_flops(cfg, B, S)
    return flops


def _attn_flops(cfg, B, S, causal: bool) -> float:
    if cfg.family == "ssm":
        # selective scan: ~ 6 * di * N flops per token per layer
        return 6.0 * cfg.d_inner * cfg.ssm_state * B * S * cfg.n_layers
    factor = 0.5 if causal else 1.0
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        ssm = 6.0 * cfg.d_inner * cfg.ssm_state * B * S * cfg.n_layers
        win = min(cfg.sliding_window or S, S)
        attn = 4.0 * B * S * win * cfg.n_heads * cfg.head_dim_ * n_attn * factor
        return ssm + attn
    L = cfg.n_layers + getattr(cfg, "n_enc_layers", 0)
    return 4.0 * B * S * S * cfg.n_heads * cfg.head_dim_ * L * factor


def _attn_decode_flops(cfg, B, S) -> float:
    if cfg.family == "ssm":
        return 6.0 * cfg.d_inner * cfg.ssm_state * B * cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        win = min(cfg.sliding_window or S, S)
        return (6.0 * cfg.d_inner * cfg.ssm_state * B * cfg.n_layers +
                4.0 * B * win * cfg.n_heads * cfg.head_dim_ * n_attn)
    return 4.0 * B * S * cfg.n_heads * cfg.head_dim_ * cfg.n_layers


def hbm_bytes(cfg, shape, n_micro: int = 1) -> float:
    """Per-step global HBM traffic estimate.  Sharding spreads this evenly,
    so the per-chip term divides by the chip count."""
    N = cfg.param_count()
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    if shape.kind == "train":
        params = 2.0 * N * 2          # bf16 read in fwd + bwd
        opt = 4.0 * N * 4 + 2.0 * N * 4   # m,v read+write f32; grads write/read
        act_ckpt = 2.0 * 2 * B * S * D * cfg.n_layers   # write+read layer inputs
        logits = 2.0 * B * S * cfg.vocab_size * 2 / max(n_micro, 1) * n_micro
        return params + opt + act_ckpt + logits
    if shape.kind == "prefill":
        params = 2.0 * N
        act = 2.0 * 2 * B * S * D * cfg.n_layers
        kv = kv_cache_bytes(cfg, B, S)
        return params + act + kv
    # decode: params once + read the whole cache
    return 2.0 * N + kv_cache_bytes(cfg, B, S)


def kv_cache_bytes(cfg, B, S) -> float:
    if cfg.family == "ssm":
        return B * cfg.n_layers * (cfg.d_inner * cfg.ssm_state * 4 +
                                   (cfg.d_conv - 1) * cfg.d_inner * 2)
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        ssm = B * cfg.n_layers * (cfg.d_inner * cfg.ssm_state * 4 +
                                  (cfg.d_conv - 1) * cfg.d_inner * 2)
        win = min(cfg.sliding_window or S, S)
        return ssm + 2.0 * B * win * cfg.n_kv_heads * cfg.head_dim_ * n_attn * 2
    L = cfg.n_layers
    kv = 2.0 * B * S * cfg.n_kv_heads * cfg.head_dim_ * L * 2
    if cfg.family == "encdec":
        kv += 2.0 * B * cfg.enc_seq * cfg.n_kv_heads * cfg.head_dim_ * L * 2
    return kv


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------

def terms(flops: float, hbm: float, coll_bytes_per_chip: float, chips: int,
          peak: float = PEAK_FLOPS) -> Dict[str, float]:
    compute = flops / (chips * peak)
    memory = hbm / (chips * HBM_BW)
    collective = coll_bytes_per_chip / LINK_BW     # already per chip
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory, "collective_s": collective,
            "dominant": dominant}
