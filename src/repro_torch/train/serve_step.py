"""Serving: prefill + batched greedy decode loop (counterpart:
`repro/train/serve_step.py`).

The prefill's caches are padded along time **by name**: only the
self-attention caches "k" and "v" grow, to `max_len`.  The reference pads
every cache leaf whose axis 2 happens to equal the prompt length, which
also pads an SSM state, a conv tail or a cross-attention cache when one of
their sizes equals the prompt's (ROADMAP queue 3 item 9).  Decoding starts
at the position after the last one the prefill consumed, which for a VLM
counts the image positions too.
"""
from __future__ import annotations

import torch

PADDED = ("k", "v")           # the caches that grow along time (axis 2)


def make_decode_step(model):
    """step(cache, tokens, pos) -> (logits, cache), the cache updated in place."""
    def step(cache, tokens, pos: int):
        return model.decode_step(cache, tokens, pos)
    return step


def pad_caches(cache: dict, max_len: int) -> dict:
    """The caches with "k" / "v" zero-padded along time to `max_len`; every
    other leaf as it is."""
    out = dict(cache)
    for name in PADDED:
        if name in cache:
            a = cache[name]
            grown = a.new_zeros((*a.shape[:2], max_len, *a.shape[3:]))
            grown[:, :, :a.shape[2]] = a
            out[name] = grown
    return out


def greedy_generate(model, prompt_tokens, max_new: int, max_len: int = 0,
                    extra_batch=None, with_logits: bool = False):
    """prompt_tokens: (B, S0).  Returns (B, S0 + max_new) tokens, and with
    `with_logits` also the (B, max_new, V) logits each new token was chosen
    from.  extra_batch: further prefill inputs (whisper's enc_frames, a VLM's
    patch_embeds)."""
    batch = {"tokens": prompt_tokens, **(extra_batch or {})}
    step = make_decode_step(model)
    with torch.no_grad():
        logits, cache = model.prefill(batch)
        start = logits.shape[1]              # positions the prefill filled
        cache = pad_caches(cache, max_len or (start + max_new))
        last = logits[:, -1, :]
        tok = torch.argmax(last, dim=-1, keepdim=True).to(prompt_tokens.dtype)
        out, seen = [prompt_tokens, tok], [last]
        for i in range(max_new - 1):
            logits, cache = step(cache, tok, start + i)
            last = logits[:, -1, :]
            tok = torch.argmax(last, dim=-1, keepdim=True).to(prompt_tokens.dtype)
            out.append(tok)
            seen.append(last)
    tokens = torch.cat(out, dim=1)
    return (tokens, torch.stack(seen, dim=1)) if with_logits else tokens
