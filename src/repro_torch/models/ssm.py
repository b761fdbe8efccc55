"""Mamba-1 selective-state-space LM, the falcon-mamba-7b family
(counterpart: `repro/models/ssm.py`).

Prefill runs the selective scan as a loop over time with a float32 state,
where the reference runs `lax.scan`; per-step tensors (dA etc.) are built
inside the step, so nothing of size O(S * d_inner * N) materialises.
Decode carries (conv tail, ssm state) per layer, O(1) in context length.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import sharding
from repro_torch.sharding import P, flat_specs

from . import layers as L
from .module import LM, generator_for, param_dtype


def dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def causal_conv(x, conv_w, conv_b):
    """Depthwise causal conv over time. x: (B, S, di); conv_w: (K, di).

    The K products are summed in float32 and rounded to x's dtype once, as
    the decode step's contraction over its window is, then the bias is
    added, so a bf16 prefill and its decode continue one function.  (The
    reference writes the sum as K bf16 adds; rounding each one moved a bf16
    decode step 0.078 from the teacher-forced forward on falcon-mamba-7b at
    full width on an H100 80GB HBM3 at 700 W, beyond the reference's own
    tolerance.)"""
    if isinstance(x, DTensor):
        return _causal_conv_sharded(x, conv_w, conv_b)
    K = conv_w.shape[0]
    pads = F.pad(x, (0, 0, K - 1, 0)).float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(K):                           # small static K (= 4)
        out = out + pads[:, t:t + x.shape[1], :] * conv_w[t].float()[None, None, :]
    return out.to(x.dtype) + conv_b[None, None, :]


def _causal_conv_sharded(x, conv_w, conv_b):
    """causal_conv on DTensors, each device on its own channels as plain
    tensors (the conv is depthwise): x sharded by batch over the
    data-parallel mesh dims and by channel over 'model', as conv_w's and
    conv_b's channels are."""
    mesh = x.device_mesh
    tp_dim = mesh.mesh_dim_names.index("model")
    n = mesh.ndim
    xp = [Shard(2) if i == tp_dim else (Shard(0) if p == Shard(0) else Replicate())
          for i, p in enumerate(x.placements)]
    batch_split = [p == Shard(0) for p in xp]

    def channels(t, dim):
        pl = [Shard(dim) if i == tp_dim else Replicate() for i in range(n)]
        grad = [Shard(dim) if i == tp_dim else (Partial() if batch_split[i] else Replicate())
                for i in range(n)]
        return sharding.as_dtensor(t, mesh).redistribute(mesh, pl).to_local(
            grad_placements=grad)

    out = causal_conv(x.redistribute(mesh, xp).to_local(grad_placements=xp),
                      channels(conv_w, 1), channels(conv_b, 0))
    return DTensor.from_local(out, mesh, xp, run_check=False)


def conv_tail(xi, K: int):
    """The last K - 1 conv inputs, the decode state.  A prompt shorter than
    K - 1 is left-padded with the causal conv's zeros (the reference slices
    short and its decode then fails)."""
    short = max(0, K - 1 - xi.shape[1])
    return (F.pad(xi, (0, 0, short, 0)) if short else xi)[:, -(K - 1):, :]


class MambaLM(LM):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        gen = generator_for(device, generator)
        dt = param_dtype(cfg)
        self.register_tree({
            "embed": {"w": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt)},
            "layers": [self._layer_params(gen, dt) for _ in range(cfg.n_layers)],
            "ln_f": L.norm_params(gen, cfg.d_model, "rmsnorm", dt),
            "lm_head": {"w": L.dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt)},
        })

    def _layer_params(self, gen, dt):
        cfg = self.cfg
        di, N, R = cfg.d_inner, cfg.ssm_state, dt_rank(cfg)
        a = torch.arange(1, N + 1, dtype=torch.float32, device=gen.device).expand(di, N)
        return {
            "norm": L.norm_params(gen, cfg.d_model, "rmsnorm", dt),
            "in_proj": L.dense_init(gen, (cfg.d_model, 2 * di), dt),
            "conv_w": L.dense_init(gen, (cfg.d_conv, di), dt, scale=1.0 / math.sqrt(cfg.d_conv)),
            "conv_b": L.zeros(gen, (di,), dt),
            "x_proj": L.dense_init(gen, (di, R + 2 * N), dt),
            "dt_proj": L.dense_init(gen, (R, di), dt, scale=1.0 / math.sqrt(R)),
            "dt_bias": L.full(gen, (di,), -4.6, dt),     # softplus^-1(0.01)
            "A_log": torch.log(a).contiguous(),          # float32
            "D": torch.ones((di,), dtype=torch.float32, device=gen.device),
            "out_proj": L.dense_init(gen, (di, cfg.d_model), dt),
        }

    def param_specs(self, mode: str = "train") -> dict:
        fsdp = "data" if mode == "train" else None
        layer = {
            "norm": {"w": P(None)},
            "in_proj": P(fsdp, "model"),
            "conv_w": P(None, "model"),
            "conv_b": P("model"),
            "x_proj": P("model", fsdp),
            "dt_proj": P(fsdp, "model"),
            "dt_bias": P("model"),
            "A_log": P("model", None),
            "D": P("model"),
            "out_proj": P("model", fsdp),
        }
        return flat_specs({"embed": {"w": P("model", fsdp)}, "layers": layer,
                           "ln_f": {"w": P(None)}, "lm_head": {"w": P(fsdp, "model")}},
                          {"layers": self.cfg.n_layers})

    @staticmethod
    def cache_specs() -> dict:
        return {"conv": P(None, "data", None, "model"),
                "ssm": P(None, "data", "model", None)}

    # -------------------------------------------------------------- block --
    @staticmethod
    def _ssm_scan(lp, xc, dtv, Bm, Cm):
        """Selective scan.  xc, dtv: (B, S, di); Bm, Cm: (B, S, N).  Returns
        (y (B, S, di) float32, final state (B, di, N) float32)."""
        A = -torch.exp(lp["A_log"])                  # (di, N)
        xs, dts = xc.float(), dtv.float()
        bs, cs = Bm.float(), Cm.float()
        B_, S, di = xc.shape
        h = torch.zeros((B_, di, Bm.shape[-1]), dtype=torch.float32, device=xc.device)

        def step(h, t):
            dt_t = dts[:, t]
            dA = torch.exp(dt_t[..., None] * A[None])                     # (B, di, N)
            dBx = (dt_t * xs[:, t])[..., None] * bs[:, t][:, None, :]
            h = dA * h + dBx
            return h, torch.einsum("bdn,bn->bd", h, cs[:, t])
        return L.time_scan(step, h, S)

    def _block(self, x, lp):
        """One layer over a sequence.  Returns (x, (conv tail, ssm state))."""
        cfg = self.cfg
        di, N, R = cfg.d_inner, cfg.ssm_state, dt_rank(cfg)
        h = L.rmsnorm(x, lp["norm"]["w"])
        xi, z = L.project_halves(h, lp["in_proj"], di)
        xc = F.silu(causal_conv(xi, lp["conv_w"], lp["conv_b"]))
        dbc = L.batch_sharded(xc @ lp["x_proj"])
        dtv = L.pointwise(F.softplus, dbc[..., :R] @ lp["dt_proj"] + lp["dt_bias"])
        Bm = dbc[..., R:R + N]
        Cm = dbc[..., R + N:]
        y, h_last = self._ssm_scan(lp, xc, dtv, Bm, Cm)
        y = y.to(x.dtype) + lp["D"].to(x.dtype) * xc
        y = y * F.silu(z)
        return x + L.batch_sharded(y @ lp["out_proj"]), (conv_tail(xi, cfg.d_conv), h_last)

    def _head(self, x):
        return L.rmsnorm(x, self.ln_f["w"]) @ self.lm_head["w"]

    # ------------------------------------------------------------ forward --
    def apply(self, batch):
        x = L.gather_rows(self.embed["w"], batch["tokens"])
        block = L.remat_block(lambda x, lp: self._block(x, lp)[0], self.cfg)
        for lp in self.layers:
            x = block(x, lp)
        return self._head(x)

    def loss(self, batch):
        logits = self.apply(batch)
        mask = batch.get("loss_mask")
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               None if mask is None else mask[:, 1:])

    # ------------------------------------------------------------- decode --
    @staticmethod
    def cache_struct(cfg: ModelConfig, batch: int, max_len: int) -> dict:
        di, N = cfg.d_inner, cfg.ssm_state
        return {"conv": ((cfg.n_layers, batch, cfg.d_conv - 1, di), param_dtype(cfg)),
                "ssm": ((cfg.n_layers, batch, di, N), torch.float32)}

    def prefill(self, batch):
        x = L.gather_rows(self.embed["w"], batch["tokens"])
        convs, ssms = [], []
        for lp in self.layers:
            x, (conv, ssm) = self._block(x, lp)
            convs.append(conv)
            ssms.append(ssm)
        return self._head(x), {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}

    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1).  O(1)-in-context single-token step; the cache's
        conv tails and states are updated in place."""
        cfg = self.cfg
        di, N, R = cfg.d_inner, cfg.ssm_state, dt_rank(cfg)
        x = L.gather_rows(self.embed["w"], tokens[:, 0])                # (B, D)
        for i, lp in enumerate(self.layers):
            conv_state, h = cache["conv"][i], cache["ssm"][i]
            hN = L.rmsnorm(x, lp["norm"]["w"])
            xi, z = L.project_halves(hN, lp["in_proj"], di)   # (B, di) each
            window = torch.cat([conv_state, xi[:, None, :]], dim=1)   # (B, K, di)
            xc = torch.einsum("bkd,kd->bd", window, lp["conv_w"]) + lp["conv_b"]
            xc = F.silu(xc)
            dbc = L.batch_sharded(xc @ lp["x_proj"])
            dtv = L.pointwise(F.softplus, dbc[..., :R] @ lp["dt_proj"] + lp["dt_bias"])
            Bm, Cm = dbc[..., R:R + N], dbc[..., R + N:]
            dA = torch.exp(dtv.float()[..., None] * (-torch.exp(lp["A_log"]))[None])
            h = dA * h + (dtv * xc).float()[..., None] * Bm.float()[:, None, :]
            y = torch.einsum("bdn,bn->bd", h, Cm.float()).to(x.dtype)
            y = y + lp["D"].to(x.dtype) * xc
            y = y * F.silu(z)
            x = x + L.batch_sharded(y @ lp["out_proj"])
            conv_state.copy_(window[:, 1:, :])
            cache["ssm"][i] = h
        logits = self._head(x)
        return logits[:, None, :], cache
