"""Synthetic LM token pipeline: deterministic, host-sharded, restartable —
a copy of `repro.data.tokens` (numpy only; same seed, same tokens).

Real fleets stream from a distributed store; the contract this module
honours is the same one a production loader needs:
  * per-(process, step) determinism -> a restarted job re-reads the exact
    batch for the step it resumes at (checkpoint/restart bit-exactness);
  * host sharding: each process materializes only its addressable slice of
    the global batch (`process_index`/`process_count`);
  * shape/dtype match input_specs() exactly.

Token stream is a mixture of Zipf-distributed ids (vocabulary skew akin to
real corpora) so loss curves are non-degenerate.
"""

from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


def batch_for_step(cfg: ModelConfig, step: int, *, global_batch: int,
                   seq_len: int, process_index: int = 0,
                   process_count: int = 1, seed: int = 17) -> dict:
    assert global_batch % process_count == 0
    local = global_batch // process_count
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, process_index]))
    a = 1.3                                   # Zipf exponent
    toks = rng.zipf(a, size=(local, seq_len)).astype(np.int64)
    toks = (toks - 1) % cfg.vocab_size
    batch = {"tokens": toks.astype(np.int32)}
    if cfg.is_enc_dec:
        s_dec = max(128, seq_len // cfg.dec_seq_divisor)
        batch = {
            "frames": rng.standard_normal(
                (local, seq_len, cfg.d_model)).astype(np.float32),
            "tokens": ((rng.zipf(a, size=(local, s_dec)) - 1)
                       % cfg.vocab_size).astype(np.int32),
        }
    elif cfg.frontend == "vision":
        p = cfg.frontend_len
        batch = {
            "tokens": toks[:, : seq_len - p].astype(np.int32),
            "embeds": rng.standard_normal(
                (local, p, cfg.d_model)).astype(np.float32),
        }
    return batch
