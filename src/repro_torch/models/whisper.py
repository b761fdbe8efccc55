"""Whisper-style encoder-decoder, whisper-base (counterpart:
`repro/models/whisper.py`).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, enc_seq, d_model), and sinusoidal
positions are added on the fly to the frames and to the decoder tokens.
Encoder: non-causal self-attention blocks.  Decoder: causal self-attention,
cross-attention to the encoder states, GELU MLP.  Decode caches: the
self-attention KV ("k" / "v", growing) and the cross-attention KV
("ck" / "cv", fixed at enc_seq, computed once by the prefill).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike

from repro_torch.sharding import P, flat_specs

from . import layers as L
from .module import LM, generator_for, param_dtype


def sinusoid_positions(positions, d_model: int):
    """positions: (S,) or (B, S) -> (..., d_model) float32 embeddings."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / (half - 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM(LM):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        gen = generator_for(device, generator)
        dt = param_dtype(cfg)
        norm = lambda: L.norm_params(gen, cfg.d_model, cfg.norm, dt)   # noqa: E731
        attn = lambda: L.attn_params(gen, cfg.d_model, cfg.n_heads,   # noqa: E731
                                     cfg.n_kv_heads, cfg.head_dim_, False, dt)
        mlp = lambda: L.gelu_mlp_params(gen, cfg.d_model, cfg.d_ff, dt)  # noqa: E731
        self.register_tree({
            "embed": {"w": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt)},
            "enc_layers": [{"ln1": norm(), "attn": attn(), "ln2": norm(), "mlp": mlp()}
                           for _ in range(cfg.n_enc_layers)],
            "ln_enc": norm(),
            "dec_layers": [{"ln1": norm(), "self_attn": attn(), "ln2": norm(),
                            "cross_attn": attn(), "ln3": norm(), "mlp": mlp()}
                           for _ in range(cfg.n_layers)],
            "ln_f": norm(),
        })

    def param_specs(self, mode: str = "train") -> dict:
        cfg = self.cfg
        fsdp = "data" if mode == "train" else None
        norm = {"w": P(None), "b": P(None)}
        attn = {"wq": P(fsdp, "model"), "wk": P(fsdp, "model"),
                "wv": P(fsdp, "model"), "wo": P("model", fsdp)}
        mlp = {"w1": P(fsdp, "model"), "b1": P("model"), "w2": P("model", fsdp),
               "b2": P(None)}
        enc = {"ln1": dict(norm), "attn": dict(attn), "ln2": dict(norm), "mlp": dict(mlp)}
        dec = {"ln1": dict(norm), "self_attn": dict(attn), "ln2": dict(norm),
               "cross_attn": dict(attn), "ln3": dict(norm), "mlp": dict(mlp)}
        return flat_specs({"embed": {"w": P("model", fsdp)}, "enc_layers": enc,
                           "ln_enc": dict(norm), "dec_layers": dec, "ln_f": dict(norm)},
                          {"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers})

    @staticmethod
    def cache_specs() -> dict:
        """Self-attention cache: sequence over model; cross cache: enc_seq
        (1 500) does not divide by 16, so it stays head_dim-sharded."""
        s = P(None, "data", "model", None, None)
        c = P(None, "data", None, None, "model")
        return {"k": s, "v": s, "ck": c, "cv": c}

    # ------------------------------------------------------------ encoder --
    def encode(self, enc_frames):
        cfg = self.cfg
        x = enc_frames.to(param_dtype(cfg))
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoid_positions(pos, cfg.d_model).to(x.dtype)[None]
        block = L.remat_block(self._enc_block, cfg)
        for lp in self.enc_layers:
            x = block(x, lp)
        return L.apply_norm(x, self.ln_enc, cfg.norm)

    def _enc_block(self, x, lp):
        cfg = self.cfg
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        q, k, v = L.attn_qkv(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
        o = L.attention_core(q, k, v, causal=False, q_chunk=cfg.q_chunk)
        x = x + L.attn_out(lp["attn"], o)
        h = L.apply_norm(x, lp["ln2"], cfg.norm)
        return x + L.gelu_mlp(lp["mlp"], h)

    # ------------------------------------------------------------ decoder --
    def _embed_tokens(self, tokens, positions):
        x = L.gather_rows(self.embed["w"], tokens)
        return x + sinusoid_positions(positions, self.cfg.d_model).to(x.dtype)

    def _dec_block(self, x, lp, enc_out):
        """One decoder layer over a sequence.  Returns (x, (k, v, kc, vc))."""
        cfg = self.cfg
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        q, k, v = L.attn_qkv(lp["self_attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
        o = L.attention_core(q, k, v, causal=True, q_chunk=cfg.q_chunk)
        x = x + L.attn_out(lp["self_attn"], o)
        h = L.apply_norm(x, lp["ln2"], cfg.norm)
        b, s, _ = h.shape
        se = enc_out.shape[1]
        ca = lp["cross_attn"]
        qc = L.split_heads(h @ ca["wq"], cfg.n_heads, cfg.head_dim_)
        kc = L.split_heads(enc_out @ ca["wk"], cfg.n_kv_heads, cfg.head_dim_)
        vc = L.split_heads(enc_out @ ca["wv"], cfg.n_kv_heads, cfg.head_dim_)
        oc = L.attention_core(qc, kc, vc, causal=False, q_chunk=cfg.q_chunk)
        x = x + L.attn_out(ca, oc)
        h = L.apply_norm(x, lp["ln3"], cfg.norm)
        return x + L.gelu_mlp(lp["mlp"], h), (k, v, kc, vc)

    def _head(self, x):
        x = L.apply_norm(x, self.ln_f, self.cfg.norm)
        return x @ self.embed["w"].T                 # whisper ties the output projection

    def apply(self, batch):
        """Teacher-forced enc-dec forward -> decoder logits."""
        return self.prefill(batch)[0]

    def loss(self, batch):
        logits = self.apply(batch)
        mask = batch.get("loss_mask")
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                               None if mask is None else mask[:, 1:])

    # ------------------------------------------------------------- decode --
    @staticmethod
    def cache_struct(cfg: ModelConfig, batch: int, max_len: int) -> dict:
        dt = param_dtype(cfg)
        kv = ((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_), dt)
        cross = ((cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim_), dt)
        return {"k": kv, "v": kv, "ck": cross, "cv": cross}

    def prefill(self, batch):
        """Encoder + teacher-forced decoder pass, returning decode caches;
        each encoder and decoder layer rematerialised in the backward
        (`L.remat_block`)."""
        enc_out = self.encode(batch["enc_frames"])
        tokens = batch["tokens"]
        x = self._embed_tokens(tokens, torch.arange(tokens.shape[1], device=tokens.device))
        block = L.remat_block(self._dec_block, self.cfg)
        kvs = []
        for lp in self.dec_layers:
            x, kv = block(x, lp, enc_out)
            kvs.append(kv)
        cache = {name: torch.stack([kv[j] for kv in kvs])
                 for j, name in enumerate(("k", "v", "ck", "cv"))}
        return self._head(x), cache

    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1); the self-attention cache is written in place, the
        cross-attention cache is read only."""
        cfg = self.cfg
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                               device=tokens.device)
        x = self._embed_tokens(tokens, positions)                    # (B, 1, D)
        for i, lp in enumerate(self.dec_layers):
            h = L.apply_norm(x, lp["ln1"], cfg.norm)
            q, k, v = L.attn_qkv(lp["self_attn"], h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim_)
            ck, cv = cache["k"][i], cache["v"][i]
            L.write_slot(ck, k, pos)
            L.write_slot(cv, v, pos)
            o = L.attention_core(q, ck, cv, causal=True, q_offset=pos)
            x = x + L.attn_out(lp["self_attn"], o)
            h = L.apply_norm(x, lp["ln2"], cfg.norm)
            qc = L.split_heads(h @ lp["cross_attn"]["wq"], cfg.n_heads, cfg.head_dim_)
            oc = L.attention_core(qc, cache["ck"][i], cache["cv"][i], causal=False)
            x = x + L.attn_out(lp["cross_attn"], oc)
            h = L.apply_norm(x, lp["ln3"], cfg.norm)
            x = x + L.gelu_mlp(lp["mlp"], h)
        return self._head(x), cache
