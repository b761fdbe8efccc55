"""Dense / VLM / MoE decoder-only transformer LM (counterpart:
`repro/models/transformer.py`).

One implementation covers stablelm-12b, llama3.2-1b, glm4-9b, qwen2.5-14b,
internvl2-2b (VLM: projected patch embeddings prepended) and the two MoE
archs (FFN swapped for a top-k expert block, see moe.py).  The layers are a
`nn.ModuleList` walked in order where the reference scans a stacked layer
axis.  The KV cache keeps the reference's layout, (L, B, T, Hkv, Dh) for
"k" and "v", and `decode_step` writes slot `pos` of it in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike

from repro_torch.sharding import P, flat_specs

from . import layers as L
from .module import LM, generator_for, param_dtype
from .moe import moe_block, moe_params, moe_specs


class TransformerLM(LM):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        gen = generator_for(device, generator)
        dt = param_dtype(cfg)
        tree = {
            "embed": {"w": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt)},
            "layers": [self._layer_params(gen, dt) for _ in range(cfg.n_layers)],
            "ln_f": L.norm_params(gen, cfg.d_model, cfg.norm, dt),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = {"w": L.dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt)}
        if cfg.family == "vlm":
            tree["vision_proj"] = {"w": L.dense_init(gen, (cfg.d_model, cfg.d_model), dt)}
        self.register_tree(tree)

    def _layer_params(self, gen, dt):
        cfg = self.cfg
        p = {
            "ln1": L.norm_params(gen, cfg.d_model, cfg.norm, dt),
            "attn": L.attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim_, cfg.qkv_bias, dt),
            "ln2": L.norm_params(gen, cfg.d_model, cfg.norm, dt),
        }
        if cfg.family == "moe":
            p["moe"] = moe_params(gen, cfg, dt)
        elif cfg.mlp == "swiglu":
            p["mlp"] = L.swiglu_params(gen, cfg.d_model, cfg.d_ff, dt)
        else:
            p["mlp"] = L.gelu_mlp_params(gen, cfg.d_model, cfg.d_ff, dt)
        return p

    def param_specs(self, mode: str = "train") -> dict:
        """{state_dict key: P}, the reference's specs without the layer
        axis: TP over 'model'; in train mode the large matrices are also
        FSDP-sharded over 'data'."""
        cfg = self.cfg
        fsdp = "data" if mode == "train" else None
        n = P(None)                              # replicated vector
        row = P(fsdp, "model")                   # [in, out] -> out over model
        col = P("model", fsdp)                   # [in, out] -> in over model
        norm = {"w": n} if cfg.norm == "rmsnorm" else {"w": n, "b": n}
        attn = {"wq": row, "wk": row, "wv": row, "wo": col}
        if cfg.qkv_bias:
            attn.update({"bq": P("model"), "bk": P("model"), "bv": P("model")})
        layer = {"ln1": dict(norm), "attn": attn, "ln2": dict(norm)}
        if cfg.family == "moe":
            layer["moe"] = moe_specs(cfg, fsdp)
        elif cfg.mlp == "swiglu":
            layer["mlp"] = {"wg": row, "wu": row, "wd": col}
        else:
            layer["mlp"] = {"w1": row, "b1": P("model"), "w2": col, "b2": n}
        specs = {"embed": {"w": P("model", fsdp)}, "layers": layer, "ln_f": dict(norm)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = {"w": P(fsdp, "model")}
        if cfg.family == "vlm":
            specs["vision_proj"] = {"w": P(None, "model")}
        return flat_specs(specs, {"layers": cfg.n_layers})

    @staticmethod
    def cache_specs() -> dict:
        """Batch over data, sequence over model (the reference's choice:
        the scores and outputs are reduced, the cache never gathered)."""
        s = P(None, "data", "model", None, None)
        return {"k": s, "v": s}

    # ------------------------------------------------------------ forward --
    def _block(self, x, lp, positions, *, window: int = 0, cache=None, i: int = 0,
               pos: int = 0):
        """One layer.  With `cache`, a decode step: k / v go to slot `pos` of
        layer i's cache and the queries attend over the whole cache.
        Returns (x, k, v)."""
        cfg = self.cfg
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        q, k, v = L.attn_qkv(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
        rd = int(cfg.head_dim_ * cfg.partial_rotary)
        q = L.apply_rope(q, positions, rd, cfg.rope_theta)
        k = L.apply_rope(k, positions, rd, cfg.rope_theta)
        if cache is None:
            o = L.attention_core(q, k, v, causal=True, window=window, q_chunk=cfg.q_chunk)
        else:
            ck, cv = cache["k"][i], cache["v"][i]
            L.write_slot(ck, k, pos)
            L.write_slot(cv, v, pos)
            o = L.attention_core(q, ck, cv, causal=True, q_offset=pos, window=window)
        x = x + L.attn_out(lp["attn"], o)
        h = L.apply_norm(x, lp["ln2"], cfg.norm)
        if cfg.family == "moe":
            x = x + moe_block(lp["moe"], h, cfg)
        elif cfg.mlp == "swiglu":
            x = x + L.swiglu(lp["mlp"], h)
        else:
            x = x + L.gelu_mlp(lp["mlp"], h)
        return x, k, v

    def _embed_inputs(self, batch):
        x = L.gather_rows(self.embed["w"], batch["tokens"])
        if self.cfg.family == "vlm":
            vis = batch["patch_embeds"].to(x.dtype) @ self.vision_proj["w"]
            x = torch.cat([vis, x], dim=1)
        return x

    def _head(self, x):
        x = L.apply_norm(x, self.ln_f, self.cfg.norm)
        head = self.embed["w"].T if self.cfg.tie_embeddings else self.lm_head["w"]
        return x @ head

    def apply(self, batch):
        """Teacher-forced forward -> logits (B, S_total, V); each layer
        rematerialised in the backward (`L.remat_block`)."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        block = L.remat_block(lambda x, lp: self._block(x, lp, positions)[0], self.cfg)
        for lp in self.layers:
            x = block(x, lp)
        return self._head(x)

    def loss(self, batch):
        """Next-token cross entropy."""
        cfg = self.cfg
        logits = self.apply(batch)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if cfg.family == "vlm":   # image positions carry no next-token loss
            logits = logits[:, cfg.n_vision_tokens:, :]
        return L.cross_entropy(logits[:, :-1], labels[:, 1:],
                               None if mask is None else mask[:, 1:])

    # ------------------------------------------------------------- decode --
    @staticmethod
    def cache_struct(cfg: ModelConfig, batch: int, max_len: int) -> dict:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": (shape, param_dtype(cfg)), "v": (shape, param_dtype(cfg))}

    def prefill(self, batch):
        """Full-sequence forward that also returns the KV cache, (L, B, S, Hkv, Dh)."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        ks, vs = [], []
        for lp in self.layers:
            x, k, v = self._block(x, lp, positions)
            ks.append(k)
            vs.append(v)
        return self._head(x), {"k": torch.stack(ks), "v": torch.stack(vs)}

    def decode_step(self, cache, tokens, pos: int, *, window: int = 0):
        """One decode step. tokens: (B, 1); pos: the slot written.  Returns
        (logits (B, 1, V), cache), the cache updated in place."""
        x = L.gather_rows(self.embed["w"], tokens)
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                               device=x.device)
        for i, lp in enumerate(self.layers):
            x, _, _ = self._block(x, lp, positions, window=window, cache=cache, i=i, pos=pos)
        return self._head(x), cache
