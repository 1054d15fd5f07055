"""E5-style embedding encoder (paper phase-1 substrate).

Bidirectional transformer + mean pooling over non-pad positions; long
texts are split into chunks, embedded independently, and mean-merged —
exactly the paper's §4.1 long-input handling.  Reuses the model substrate's
attention/MLP layers with causal=False (plain attention: the reference
runs no kernel here, and neither does the port).

Weights: ``init_encoder_params`` draws random ones from an explicit
``torch.Generator``; ``repro_torch.models.lm.encoder_params_from_jax``
carries the reference's ``init_encoder_params`` tree across.  Every entry
point runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.utils.device import resolve_device

_PATTERN = LayerSpec(kind="attn", ffn="dense")


def init_encoder_params(cfg: ModelConfig, generator: torch.Generator,
                        device="cuda") -> dict:
    """Random encoder weights on ``device`` in ``cfg.dtype``: an embedding
    table (std 1/sqrt(D)), ``n_layers`` one-layer blocks and a final norm.
    ``generator`` must live on ``device``."""
    lm._check_supported(cfg, encoder=True)
    dev = resolve_device(device)
    D = cfg.d_model
    return {"embed": {"table": lm._normal(cfg, generator, dev,
                                          (cfg.padded_vocab, D), D)},
            "blocks": [{"l0": lm.init_layer(cfg, _PATTERN, generator, dev)}
                       for _ in range(cfg.n_layers)],
            "final_norm": lm.init_norm(cfg, dev)}


def encoder_forward(cfg: ModelConfig, params, tokens, mask):
    """tokens (B,S) int, mask (B,S) bool -> pooled embeddings (B, D) f32."""
    h = params["embed"]["table"][tokens]
    B, S, D = h.shape
    pos = torch.arange(S, device=h.device)[None, :]
    h = h + L.sinusoidal_positions(pos, D).to(h.dtype)
    for sb in params["blocks"]:
        p = sb["l0"]
        hn = L.apply_norm(cfg, p["norm"], h)
        h = h + L.attention_plain(cfg, p["attn"], hn, causal=False,
                                  rope=False)
        hf = L.apply_norm(cfg, p["ffn_norm"], h)
        h = h + L.apply_mlp(cfg, p["ffn"], hf)
    h = L.apply_norm(cfg, params["final_norm"], h)
    m = mask[..., None].float()
    pooled = torch.sum(h.float() * m, dim=1) / torch.clamp(
        torch.sum(m, dim=1), min=1.0)
    return pooled / torch.clamp(
        torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-9)


class EmbeddingModel:
    """Texts -> L2-normalised embeddings through ``encoder_forward``.

    params: the port's encoder parameters on ``device`` (default: random
    from ``torch.Generator(device).manual_seed(seed)``).  Pass
    ``model.encode`` as a session's ``embedder``.
    """

    def __init__(self, cfg: ModelConfig, params=None, seed: int = 0,
                 max_len: int = 128, tokenizer: HashTokenizer = None, *,
                 device="cuda"):
        lm._check_supported(cfg, encoder=True)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_encoder_params(cfg, gen, self.device)
        self.params = params
        self.max_len = max_len
        self.tok = tokenizer or HashTokenizer(cfg.vocab_size)

    @torch.inference_mode()
    def _embed(self, toks: np.ndarray, mask: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(toks).to(self.device, torch.long)
        m = torch.from_numpy(mask).to(self.device)
        return encoder_forward(self.cfg, self.params, t, m).cpu().numpy()

    def encode(self, texts: Sequence[str], batch: int = 64) -> np.ndarray:
        """Chunked embedding: mean of per-chunk embeddings (paper §4.1)."""
        chunks: List[List[int]] = []
        owner: List[int] = []
        for i, t in enumerate(texts):
            ids = self.tok.encode(t)
            for s in range(0, max(1, len(ids)), self.max_len):
                chunks.append(ids[s:s + self.max_len])
                owner.append(i)
        out = np.zeros((len(texts), self.cfg.d_model), np.float32)
        counts = np.zeros(len(texts), np.float32)
        for s in range(0, len(chunks), batch):
            group = chunks[s:s + batch]
            L_max = self.max_len
            toks = np.zeros((len(group), L_max), np.int32)
            mask = np.zeros((len(group), L_max), bool)
            for r, c in enumerate(group):
                toks[r, :len(c)] = c
                mask[r, :len(c)] = True
            emb = self._embed(toks, mask)
            for r, o in enumerate(owner[s:s + batch]):
                out[o] += emb[r]
                counts[o] += 1
        out /= np.maximum(counts[:, None], 1.0)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-9)


def encode_texts(texts, cfg=None, seed=0, max_len=128, device="cuda"):
    from repro_torch.configs import smoke_config
    cfg = cfg or smoke_config("e5-large")
    return EmbeddingModel(cfg, seed=seed, max_len=max_len,
                          device=device).encode(texts)
