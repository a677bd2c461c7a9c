"""Serve a reduced LM: prefill, then greedy decode against the KV cache —
port of `examples/serve_lm.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --arch gemma2-9b --new 12 [--device cpu]

`reduced_config(arch)` (float32, two layers a group), random params from
seed 0, a [2, 8] prompt drawn from seed 1; one prefill into a cache
of 8 + `--new` slots and `--new - 1` decode steps through
`serve.step.build_prefill_step` / `build_decode_step`. Decoder configs
only: an enc-dec model's steps also take the encoder's frames
(`serve.step`).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.init import init_params
from repro_torch.params import params_to
from repro_torch.serve.step import build_decode_step, build_prefill_step

PROMPT_SHAPE = (2, 8)


def generate(params, cfg, prompt, n_new: int, device) -> tuple:
    """Greedy tokens [B, n_new] (int64, CPU) and, for each of them, the
    top-2 margin of the logits it was picked from [B, n_new] (float32,
    CPU)."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    prompt = torch.as_tensor(prompt).to(dev)
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
    logits, caches, pos = prefill(params, prompt,
                                  cache_len=prompt.shape[1] + n_new)
    toks, margins = [], []
    for i in range(n_new):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        toks.append(torch.argmax(logits, -1))
        if i + 1 < n_new:
            logits, caches, pos = decode(params, toks[-1][:, None], caches,
                                         pos)
    return (torch.stack(toks, 1).cpu(), torch.stack(margins, 1).cpu())


def main(argv=None, *, params=None, prompt=None) -> dict:
    """Runs the example; returns the prompt, tokens and margins. `params`
    and `prompt` replace the seeded draws."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--new", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch)
    dev = resolve_device(args.device)
    if params is None:
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             device=dev)
    if prompt is None:
        prompt = torch.randint(
            0, cfg.vocab_size, PROMPT_SHAPE,
            generator=torch.Generator().manual_seed(1))
    prompt = torch.as_tensor(prompt)
    out, margins = generate(params, cfg, prompt, args.new, dev)
    print(f"arch={args.arch} (reduced) prompt={prompt.tolist()}")
    print(f"greedy continuation: {out.tolist()}")
    return {"prompt": prompt, "tokens": out, "margins": margins, "cfg": cfg}


if __name__ == "__main__":
    main()
