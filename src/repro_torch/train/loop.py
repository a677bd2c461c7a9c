"""Training loop: checkpoint/restart, straggler detection, failure recovery
— port of `repro.train.loop`.

Fault-tolerance contract (DESIGN.md §6):
  * checkpoint every `ckpt_every` steps (atomic, keep-k — ckpt/manager.py);
  * `resume="auto"` restores the latest valid checkpoint and *replays the
    data stream deterministically* (batch_fn is keyed by step);
  * StragglerMonitor keeps an EWMA of step wall-time; a step slower than
    `threshold x` EWMA is flagged — on a real fleet the runner would evict
    the slow host and restart from the last checkpoint (here: logged and
    counted);
  * any exception inside the step triggers a restore-and-retry
    (`max_retries`).

A step's time ends when its loss is ready: a loss on the card is waited
for with `torch.cuda.synchronize` before the clock is read, so the EWMA
times device work, not the enqueue.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.ckpt import manager as ckpt


@dataclass
class StragglerMonitor:
    threshold: float = 3.0
    alpha: float = 0.2            # EWMA weight
    ewma: float | None = None
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flagged.append((step, dt, self.ewma))
        # straggler steps don't poison the baseline
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(
            dt, self.threshold * self.ewma)
        return slow


def _wait(loss) -> None:
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def run(step_fn, params, opt_state, batch_fn, *, n_steps: int,
        ckpt_dir: str | None = None, ckpt_every: int = 50,
        resume: str | None = "auto", max_retries: int = 2,
        log_every: int = 10, monitor: StragglerMonitor | None = None,
        on_metrics=None, on_resume=None):
    """The loop behind launch/train.py and the failure-recovery
    tests. batch_fn(step) -> batch; step_fn(params, opt_state, batch) ->
    (params, opt_state, metrics). Returns (params, opt_state, history).

    Resume goes through VERIFIED restore: the newest checkpoint that
    passes format-version + checksum verification wins, and torn,
    bit-flipped or missing newer ones are walked past (reported through
    `on_resume(step, skipped)`) — the loop never deserializes a checkpoint
    it cannot verify. Restored leaves land on the devices, shardings and
    dtypes of the current `params` and `opt_state`: a run on an LM mesh
    (leaves stored as per-device blocks) resumes onto its own layout,
    whatever mesh wrote the checkpoint.
    """
    monitor = monitor or StragglerMonitor()
    start = 0
    if ckpt_dir and resume == "auto":
        last, skipped = ckpt.latest_valid_step(ckpt_dir)
        for s, problems in skipped:
            print(f"[loop] skipping corrupt checkpoint step {s}: "
                  f"{problems[0]}")
        if on_resume is not None:
            on_resume(last, skipped)
        if last is not None:
            params, opt_state = ckpt.restore(ckpt_dir, last,
                                             (params, opt_state))
            start = last
            print(f"[loop] resumed from step {last}"
                  + (f" (walked back past {len(skipped)} corrupt)"
                     if skipped else ""))

    history = []
    step = start
    retries = 0
    while step < n_steps:
        try:
            t0 = time.time()
            batch = batch_fn(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            _wait(metrics["loss"])
            dt = time.time() - t0
            slow = monitor.observe(step, dt)
            if slow:
                print(f"[loop] straggler at step {step}: {dt:.3f}s "
                      f"(ewma {monitor.ewma:.3f}s) — would evict+restart "
                      "on fleet")
            if step % log_every == 0 or step == n_steps - 1:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["sec_per_step"] = dt
                history.append(rec)
                if on_metrics:
                    on_metrics(step, rec)
            step += 1
            if ckpt_dir and step % ckpt_every == 0:
                ckpt.save(ckpt_dir, step, (params, opt_state))
            retries = 0
        except Exception:
            retries += 1
            if not ckpt_dir or retries > max_retries:
                raise
            last, _ = ckpt.latest_valid_step(ckpt_dir)
            print(f"[loop] step {step} failed; restoring step {last} "
                  f"(retry {retries}/{max_retries})")
            if last is not None:
                params, opt_state = ckpt.restore(ckpt_dir, last,
                                                 (params, opt_state))
                step = last
    if ckpt_dir:
        ckpt.save(ckpt_dir, step, (params, opt_state))
    return params, opt_state, history
