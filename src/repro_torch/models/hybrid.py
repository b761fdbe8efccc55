"""Zamba2-style hybrid LM: a Mamba-2 backbone with one *shared* attention
block invoked after every `attn_every` SSM layers, its weights reused at
every invocation (counterpart: `repro/models/hybrid.py`).

Mamba-2 recurrence (per head h, head dim Ph, state N):
    S_t = exp(dt_t * a_h) * S_{t-1} + dt_t * (x_t outer B_t)
    y_t = S_t C_t + D_h x_t
with a scalar a_h per head.  The layers after the last whole group (the
tail) run without a following attention block.  `window > 0` runs the
shared attention with a sliding window.  Caches: "conv" and "ssm" per SSM
layer, "k" / "v" with one slot per group (per invocation site).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike

from repro_torch.sharding import P, flat_specs

from . import layers as L
from .module import LM, generator_for, param_dtype
from .ssm import causal_conv, conv_tail


class HybridLM(LM):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.attn_every <= 0:
            raise ValueError("a hybrid config needs attn_every > 0")
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.n_tail = cfg.n_layers - self.n_groups * cfg.attn_every
        gen = generator_for(device, generator)
        dt = param_dtype(cfg)
        self.register_tree({
            "embed": {"w": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt)},
            "mamba": [self._mamba2_layer(gen, dt) for _ in range(cfg.n_layers)],
            "shared_attn": {
                "ln1": L.norm_params(gen, cfg.d_model, "rmsnorm", dt),
                "attn": L.attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim_, False, dt),
                "ln2": L.norm_params(gen, cfg.d_model, "rmsnorm", dt),
                "mlp": L.swiglu_params(gen, cfg.d_model, cfg.d_ff, dt),
            },
            "ln_f": L.norm_params(gen, cfg.d_model, "rmsnorm", dt),
            "lm_head": {"w": L.dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt)},
        })

    def _mamba2_layer(self, gen, dt):
        cfg = self.cfg
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        return {
            "norm": L.norm_params(gen, cfg.d_model, "rmsnorm", dt),
            "in_proj": L.dense_init(gen, (cfg.d_model, 2 * di), dt),
            "conv_w": L.dense_init(gen, (cfg.d_conv, di), dt, scale=0.5),
            "conv_b": L.zeros(gen, (di,), dt),
            "bcdt_proj": L.dense_init(gen, (di, 2 * N + H), dt),
            "dt_bias": L.full(gen, (H,), -4.6, torch.float32),
            "a_log": L.zeros(gen, (H,), torch.float32),
            "D": torch.ones((H,), dtype=torch.float32, device=gen.device),
            "out_proj": L.dense_init(gen, (di, cfg.d_model), dt),
        }

    def param_specs(self, mode: str = "train") -> dict:
        fsdp = "data" if mode == "train" else None
        mamba = {
            "norm": {"w": P(None)},
            "in_proj": P(fsdp, "model"),
            "conv_w": P(None, "model"),
            "conv_b": P("model"),
            "bcdt_proj": P("model", fsdp),
            "dt_bias": P(None),
            "a_log": P(None),
            "D": P(None),
            "out_proj": P("model", fsdp),
        }
        attn = {
            "ln1": {"w": P(None)},
            "attn": {"wq": P(fsdp, "model"), "wk": P(fsdp, "model"),
                     "wv": P(fsdp, "model"), "wo": P("model", fsdp)},
            "ln2": {"w": P(None)},
            "mlp": {"wg": P(fsdp, "model"), "wu": P(fsdp, "model"), "wd": P("model", fsdp)},
        }
        return flat_specs({"embed": {"w": P("model", fsdp)}, "mamba": mamba,
                           "shared_attn": attn, "ln_f": {"w": P(None)},
                           "lm_head": {"w": P(fsdp, "model")}},
                          {"mamba": self.cfg.n_layers})

    @staticmethod
    def cache_specs() -> dict:
        return {"conv": P(None, "data", None, "model"),
                "ssm": P(None, "data", "model", None, None),
                "k": P(None, "data", "model", None, None),
                "v": P(None, "data", "model", None, None)}

    def _sites(self):
        """(layer index, attention slot or None): every SSM layer in order,
        with the slot of the shared-attention call that follows it."""
        A = self.cfg.attn_every
        for i in range(self.cfg.n_layers):
            g = i // A
            yield i, (g if (i + 1) % A == 0 and g < self.n_groups else None)

    # -------------------------------------------------------------- mamba --
    def _mamba2_block(self, x, lp):
        """One SSM layer over a sequence.  Returns (x, (conv tail, state))."""
        cfg = self.cfg
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        Ph = di // H
        h = L.rmsnorm(x, lp["norm"]["w"])
        xi, z = L.project_halves(h, lp["in_proj"], di)
        xc = F.silu(causal_conv(xi, lp["conv_w"], lp["conv_b"]))
        bcdt = L.batch_sharded(xc @ lp["bcdt_proj"])
        Bm = bcdt[..., :N].float()
        Cm = bcdt[..., N:2 * N].float()
        dtv = L.pointwise(F.softplus, bcdt[..., 2 * N:].float() + lp["dt_bias"])   # (B, S, H)
        a = -torch.exp(lp["a_log"])                                   # (H,)
        B_, S = x.shape[0], x.shape[1]
        xh = xc.reshape(B_, S, H, Ph).float()
        state = torch.zeros((B_, H, Ph, N), dtype=torch.float32, device=x.device)

        def step(state, t):
            dt_t = dtv[:, t]
            da = torch.exp(dt_t * a[None])                            # (B, H)
            upd = (dt_t[..., None, None] * xh[:, t][..., None]) * Bm[:, t][:, None, None, :]
            state = da[..., None, None] * state + upd
            return state, torch.einsum("bhpn,bn->bhp", state, Cm[:, t])
        y, state = L.time_scan(step, state, S)                        # (B, S, H, Ph)
        y = y + lp["D"][None, None, :, None] * xh
        y = y.reshape(B_, S, di).to(x.dtype)
        y = y * F.silu(z)
        return x + L.batch_sharded(y @ lp["out_proj"]), (conv_tail(xi, cfg.d_conv), state)

    def _mamba2_decode(self, x, lp, conv_state, state):
        cfg = self.cfg
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        Ph = di // H
        h = L.rmsnorm(x, lp["norm"]["w"])
        xi, z = L.project_halves(h, lp["in_proj"], di)
        window = torch.cat([conv_state, xi[:, None, :]], dim=1)
        xc = F.silu(torch.einsum("bkd,kd->bd", window, lp["conv_w"]) + lp["conv_b"])
        bcdt = L.batch_sharded(xc @ lp["bcdt_proj"])
        Bm, Cm = bcdt[..., :N], bcdt[..., N:2 * N]
        dtv = L.pointwise(F.softplus, bcdt[..., 2 * N:].float() + lp["dt_bias"])
        a = -torch.exp(lp["a_log"])
        da = torch.exp(dtv * a[None])
        xh = xc.reshape(-1, H, Ph).float()
        upd = (dtv[..., None, None] * xh[..., None]) * Bm.float()[:, None, None, :]
        state = da[..., None, None] * state + upd
        y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
        y = y + lp["D"][None, :, None] * xh
        y = y.reshape(-1, di).to(x.dtype) * F.silu(z)
        return x + L.batch_sharded(y @ lp["out_proj"]), window[:, 1:, :], state

    # ---------------------------------------------------------- attention --
    def _attn_block(self, x, positions, window: int = 0, cache=None, g: int = 0,
                    pos: int = 0):
        """The shared block.  With `cache`, a decode step on slot g's KV
        cache.  Returns (x, k, v)."""
        cfg = self.cfg
        ap = self.shared_attn
        h = L.rmsnorm(x, ap["ln1"]["w"])
        q, k, v = L.attn_qkv(ap["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
        q = L.apply_rope(q, positions, cfg.head_dim_, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.head_dim_, cfg.rope_theta)
        if cache is None:
            o = L.attention_core(q, k, v, causal=True, window=window, q_chunk=cfg.q_chunk)
        else:
            ck, cv = cache["k"][g], cache["v"][g]
            L.write_slot(ck, k, pos)
            L.write_slot(cv, v, pos)
            o = L.attention_core(q, ck, cv, causal=True, q_offset=pos, window=window)
        x = x + L.attn_out(ap["attn"], o)
        h = L.rmsnorm(x, ap["ln2"]["w"])
        return x + L.swiglu(ap["mlp"], h), k, v

    def _head(self, x):
        return L.rmsnorm(x, self.ln_f["w"]) @ self.lm_head["w"]

    # ------------------------------------------------------------ forward --
    def apply(self, batch, window: int = 0):
        return self.prefill(batch, window)[0]

    def loss(self, batch):
        logits = self.apply(batch)
        mask = batch.get("loss_mask")
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               None if mask is None else mask[:, 1:])

    def prefill(self, batch, window: int = 0):
        """Forward pass that also returns decode-ready caches; each SSM
        layer rematerialised in the backward (`L.remat_block`), the shared
        attention block not, as in the reference."""
        x = L.gather_rows(self.embed["w"], batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        mamba = L.remat_block(self._mamba2_block, self.cfg)
        convs, ssms, ks, vs = [], [], [], []
        for i, g in self._sites():
            x, (conv, ssm) = mamba(x, self.mamba[i])
            convs.append(conv)
            ssms.append(ssm)
            if g is not None:
                x, k, v = self._attn_block(x, positions, window)
                ks.append(k)
                vs.append(v)
        return self._head(x), {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                               "k": torch.stack(ks), "v": torch.stack(vs)}

    # ------------------------------------------------------------- decode --
    @staticmethod
    def cache_struct(cfg: ModelConfig, batch: int, max_len: int) -> dict:
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        G = cfg.n_layers // cfg.attn_every
        kv = ((G, batch, max_len, cfg.n_kv_heads, cfg.head_dim_), param_dtype(cfg))
        return {"conv": ((cfg.n_layers, batch, cfg.d_conv - 1, di), param_dtype(cfg)),
                "ssm": ((cfg.n_layers, batch, H, di // H, N), torch.float32),
                "k": kv, "v": kv}

    def decode_step(self, cache, tokens, pos: int, *, window: int = 0):
        """tokens: (B, 1); the cache is updated in place."""
        x = L.gather_rows(self.embed["w"], tokens[:, 0])
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                               device=x.device)
        for i, g in self._sites():
            x, conv, state = self._mamba2_decode(x, self.mamba[i], cache["conv"][i],
                                                 cache["ssm"][i])
            cache["conv"][i] = conv
            cache["ssm"][i] = state
            if g is not None:
                xs, _, _ = self._attn_block(x[:, None, :], positions, window, cache, g, pos)
                x = xs[:, 0, :]
        return self._head(x)[:, None, :], cache
