"""Input, cache and param specs for every (arch x shape x mesh) cell —
port of `repro.launch.specs`.

Where the JAX package describes a step's arguments with
`ShapeDtypeStruct`s, the port makes meta tensors: the same shapes and
dtypes, no data and no device memory, which the port's own steps run on
(`launch/dryrun.py`). Tokens and cache positions are int32, as in the
JAX package; the port's steps take them as they are (the embedding casts
ids to int64 where it indexes).

Layouts. Params and AdamW moments take the JAX package's specs
(`sharding.param_shardings`, the `_PARAM_RULES`), as `NamedSharding`s of
the port's `LMMesh`. The port lays nothing else out by a spec: a
data-parallel replica takes its rows of the batch
(`tensor_parallel.model_rows`, `sharding.replica_positions`), and a
serving cache is a `tensor_parallel.TPCache`, each member's cache with
its heads' K and V (its channels' Mamba states, its heads' wkv states;
the `pos` planes and shift states whole on every member), the replicas'
rows apart. The JAX package cuts its attention caches by cache sequence
over `model` instead (`cache_shardings`), so no `cache_shardings` is
ported: `cache_specs` gives the unsharded cache, and the port's layout of
it is the one its serving step makes (`dryrun.build_cell`).
"""

from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWState

BF16 = torch.bfloat16
I32 = torch.int32


def dec_len(cfg: ModelConfig, seq_len: int) -> int:
    return max(128, seq_len // cfg.dec_seq_divisor) if cfg.is_enc_dec \
        else seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def step_inputs(cfg: ModelConfig, kind: str, batch: int, seq_len: int
                ) -> dict:
    """Meta tensors of a step's data arguments for `cfg` at `batch` x
    `seq_len` (the JAX dry run's `_train_inputs` / `_decode_inputs`):
    frames and decoder tokens (enc-dec), tokens and patch embeddings
    (vision), or tokens; for decode the next token and the cache
    positions (and enc_out)."""
    b, s, d = batch, seq_len, cfg.d_model
    if kind in ("train", "prefill"):
        if cfg.is_enc_dec:
            return {"frames": _meta((b, s, d), BF16),
                    "tokens": _meta((b, dec_len(cfg, s)), I32)}
        if cfg.frontend == "vision":
            p = cfg.frontend_len
            return {"tokens": _meta((b, s - p), I32),
                    "embeds": _meta((b, p, d), BF16)}
        return {"tokens": _meta((b, s), I32)}
    if kind != "decode":
        raise ValueError(f"unknown step kind {kind!r}")
    out = {"token": _meta((b, 1), I32), "cache_pos": _meta((b,), I32)}
    if cfg.is_enc_dec:
        out["enc_out"] = _meta((b, s, d), BF16)
    return out


def input_specs(arch: str, shape: str) -> dict:
    """Meta tensors for the step function's *data* arguments of `arch`'s
    full config at `SHAPES[shape]` (params and caches have their own
    spec builders below)."""
    sh = SHAPES[shape]
    return step_inputs(get_config(arch), sh["kind"], sh["global_batch"],
                       sh["seq_len"])


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> list:
    """The unsharded decode cache (`lm.init_cache`) on meta."""
    return lm.init_cache(cfg, batch, cache_len, device="meta")


def param_shardings_abstract(rt: sharding.Runtime, params_abstract):
    """The `NamedSharding` of every param leaf by `param_spec` (the JAX
    package's rules); ValueError on an uneven split."""
    return sharding.param_shardings(rt, params_abstract)


def opt_state_shardings(rt: sharding.Runtime, params_shardings
                        ) -> AdamWState:
    """m and v laid out as the params are; the step counter replicated."""
    rep = sharding.NamedSharding(rt.lm_mesh, sharding.P())
    return AdamWState(step=rep, m=params_shardings, v=params_shardings)
