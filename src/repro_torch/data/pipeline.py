"""Deterministic synthetic data pipeline. The port's own copy of
`repro/data/pipeline.py` (numpy only): batches are bitwise equal to the
reference's.

No external datasets are available offline, so the pipeline generates a
*learnable* synthetic language: each sequence follows a degree-2 affine
recurrence over a reduced alphabet with occasional uniform noise. Models
that can condition on context reduce loss well below the unigram entropy,
which is what the benchmark suite needs to compare architectures (the
paper's C4 task is substituted by this; relative comparisons carry over).

Determinism contract: batch content is a pure function of
(seed, step, host_index, num_hosts) — restarts and elastic re-scales
reproduce the exact token stream (fault-tolerance tests rely on this).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.config import ModelConfig, TrainConfig


def _rng(seed: int, step: int, salt: int = 0) -> np.random.Generator:
    key = (np.uint64(seed) << np.uint64(32)) ^ np.uint64(salt * 0x5e17 + 1)
    return np.random.Generator(
        np.random.Philox(key=[int(key), int(step)]))


def _recurrence_tokens(rng: np.random.Generator, B: int, S: int,
                       vocab: int, seed: int = 0) -> np.ndarray:
    """t_{i+1} = (a*t_i + b*t_{i-1} + c) mod V_eff, 10% uniform noise.

    (a, b, c) is drawn per sequence from 8 fixed-per-seed "languages", so
    a model must (i) memorize 8 affine maps over a 256 alphabet —
    capacity-bound — and (ii) infer in-context which language it is in.
    Capacity-increasing methods (AltUp!) separate from baselines here."""
    v_eff = min(vocab, 256)
    lang_rng = _rng(seed, 0, salt=9)
    n_lang = 8
    la = lang_rng.integers(1, 7, size=n_lang)
    lb = lang_rng.integers(0, 5, size=n_lang)
    lc = lang_rng.integers(0, v_eff, size=n_lang)
    pick = rng.integers(0, n_lang, size=B)
    a = la[pick][:, None]
    b = lb[pick][:, None]
    c = lc[pick][:, None]
    toks = np.zeros((B, S), np.int64)
    toks[:, 0] = rng.integers(0, v_eff, size=B)
    toks[:, 1] = rng.integers(0, v_eff, size=B)
    for i in range(1, S - 1):
        nxt = (a[:, 0] * toks[:, i] + b[:, 0] * toks[:, i - 1] + c[:, 0]) \
            % v_eff
        noise = rng.random(B) < 0.1
        nxt = np.where(noise, rng.integers(0, v_eff, size=B), nxt)
        toks[:, i + 1] = nxt
    return toks.astype(np.int32)


def host_slice(B: int, host_index: int = 0, num_hosts: int = 1) -> slice:
    """Each host generates only its slice of the global batch."""
    per = B // num_hosts
    return slice(host_index * per, (host_index + 1) * per)


def lm_batch(cfg: ModelConfig, B: int, S: int, seed: int, step: int,
             host_index: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
    """Causal-LM batch: predict token t+1 from prefix."""
    rng = _rng(seed, step)
    toks = _recurrence_tokens(rng, B, S + 1, cfg.vocab_size, seed)
    sl = host_slice(B, host_index, num_hosts)
    toks = toks[sl]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": np.ones((toks.shape[0], S), np.float32)}
    if cfg.family == "vlm":
        rngi = _rng(seed, step, salt=1)
        batch["extra_embeds"] = rngi.standard_normal(
            (toks.shape[0], cfg.n_image_tokens, cfg.d_model),
            dtype=np.float32)
    if cfg.family == "encdec":
        rngf = _rng(seed, step, salt=2)
        batch["encoder_frames"] = rngf.standard_normal(
            (toks.shape[0], cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return batch


def span_corruption_batch(cfg: ModelConfig, B: int, S_enc: int, S_dec: int,
                          seed: int, step: int, host_index: int = 0,
                          num_hosts: int = 1,
                          corruption_rate: float = 0.15,
                          mean_span: int = 3) -> Dict[str, np.ndarray]:
    """T5-style span corruption (the paper's pretraining task).

    Encoder sees text with corrupted spans replaced by sentinels; decoder
    autoregressively predicts sentinel-delimited spans. Sentinels occupy
    the top of the vocabulary (T5 convention)."""
    rng = _rng(seed, step, salt=3)
    toks = _recurrence_tokens(rng, B, S_enc, cfg.vocab_size, seed)
    sl = host_slice(B, host_index, num_hosts)
    toks = toks[sl]
    Bl = toks.shape[0]
    n_sent = 16
    sent0 = cfg.vocab_size - 1          # sentinel ids go downward
    enc = np.full((Bl, S_enc), 0, np.int32)
    dec_in = np.zeros((Bl, S_dec), np.int32)
    dec_tg = np.zeros((Bl, S_dec), np.int32)
    dec_mask = np.zeros((Bl, S_dec), np.float32)
    for b in range(Bl):
        i = e = 0                      # encoder write pos
        di = 0                         # decoder write pos
        s_id = 0
        pos = 0
        while pos < S_enc and e < S_enc:
            if (rng.random() < corruption_rate / mean_span
                    and s_id < n_sent and di + 1 < S_dec):
                span = min(1 + rng.integers(0, 2 * mean_span),
                           S_enc - pos, S_dec - di - 1)
                enc[b, e] = sent0 - s_id
                e += 1
                dec_in[b, di] = sent0 - s_id
                for j in range(span):
                    dec_tg[b, di] = toks[b, pos + j]
                    dec_mask[b, di] = 1.0
                    if di + 1 < S_dec:
                        dec_in[b, di + 1] = toks[b, pos + j]
                    di += 1
                    if di >= S_dec:
                        break
                pos += span
                s_id += 1
            else:
                enc[b, e] = toks[b, pos]
                e += 1
                pos += 1
    return {"tokens": dec_in, "labels": dec_tg, "mask": dec_mask,
            "encoder_frames": enc}


def make_batch(cfg: ModelConfig, tcfg: TrainConfig, step: int,
               host_index: int = 0, num_hosts: int = 1):
    if tcfg.task == "span_corruption":
        if cfg.family != "encdec":
            raise ValueError("span_corruption is the encoder-decoder "
                             f"task; family is {cfg.family!r}")
        return span_corruption_batch(cfg, tcfg.global_batch,
                                     cfg.encoder_seq or tcfg.seq_len,
                                     tcfg.seq_len, tcfg.seed, step,
                                     host_index, num_hosts)
    return lm_batch(cfg, tcfg.global_batch, tcfg.seq_len, tcfg.seed, step,
                    host_index, num_hosts)
