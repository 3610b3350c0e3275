"""The overlay's cadence, best-loss tracking and LR-drop signalling (port
of ``apply_overlay`` and ``BestTracker`` in ``pixray_tpu/engine/schedule.py``)."""

from __future__ import annotations

from dataclasses import dataclass


def apply_overlay(args, cur_it: int) -> bool:
    """Is the overlay image pasted over the canvas and re-encoded before step ``cur_it``?"""
    return (
        args.overlay_image is not None
        and (cur_it % args.overlay_every) == args.overlay_offset
        and (args.overlay_until is None or cur_it < args.overlay_until)
    )

ITER_DROP_DELAY = 12


@dataclass
class BestTracker:
    best_loss: float = 1e20
    best_iter: int = 0
    num_loss_drop: int = 0
    max_loss_drops: int = 2
    iter_drop_delay: int = ITER_DROP_DELAY

    def check(self, cur_iter: int, loss_sum: float) -> bool:
        """Record ``loss_sum``; True when staleness warrants an LR drop."""
        if loss_sum < self.best_loss:
            self.best_loss = loss_sum
            self.best_iter = cur_iter
            return False
        return (cur_iter - self.best_iter) >= self.iter_drop_delay

    def register_drop(self, cur_iter: int) -> bool:
        """Apply a drop; False when the run should stop (drops exhausted)."""
        self.num_loss_drop += 1
        if self.num_loss_drop > self.max_loss_drops:
            return False
        self.best_iter = cur_iter
        self.best_loss = 1e20
        return True

    @property
    def drop_divisor(self) -> float:
        return 10.0 ** self.num_loss_drop
