"""Engine: session init and the host-side run loop (port of ``pixray_tpu/engine/core.py``).

``Engine(settings, device)`` seeds the run, builds the drawer, the
perceptors and their prompt tables, and runs ``train``/``checkin``/``run``
with the JAX engine's cadence (checkin at ``save_every`` and at the end,
LR drops with a fresh optimizer state, best-loss tracking read one step
late so the host never waits on the step it just queued).

``device`` is explicit and defaults to ``"cuda"``; asking for CUDA where
there is none raises (there is no CPU fallback).  The post-warp epilogue
and the towers compute in bfloat16 on CUDA when ``--precision bf16`` (the
default), in float32 on the CPU.

The latent is a tensor (pixel) or a dict of tensors (clipdraw,
line_sketch); a drawer with ``get_opts`` brings its own optimizer (one Adam
per group), as in the JAX engine.  ``--save_svg`` writes the drawer's
vector export at the end of ``run``.

Settings the ported slices do not implement raise ``NotImplementedError``
here rather than being ignored.
"""

from __future__ import annotations

import hashlib
import os
import random

import numpy as np
import torch

from pixray_tpu_torch.drawers import drawer_class
from pixray_tpu_torch.engine import cutouts as C
from pixray_tpu_torch.engine.latent import ravel, tree_map
from pixray_tpu_torch.engine.optimizers import build_optimizer
from pixray_tpu_torch.engine.prompts import build_prompt_tables
from pixray_tpu_torch.engine.schedule import BestTracker
from pixray_tpu_torch.engine.step import PerceptorSpec, StepConfig, train_step
from pixray_tpu_torch.io import output as OUT
from pixray_tpu_torch.models.perceptor import Perceptor
from pixray_tpu_torch.utils import get_file_path

# (setting, value that means "off") for everything not ported yet
_UNPORTED = [
    ("init_image", None), ("overlay_image", None), ("target_images", None),
    ("image_prompts", []), ("spot_prompts", []), ("spot_prompts_off", []),
    ("labels", []), ("image_labels", None),
    ("noise_prompt_seeds", []), ("animation_dir", None), ("make_video", False),
    ("resume_from", None), ("checkpoint_every", 0), ("profile_dir", None),
    ("init_weight_pix", 0.0),
]


def resolve_seed(seed_setting):
    """int / numeric-string / arbitrary-string (sha512) / None seeding."""
    if seed_setting is None:
        return int.from_bytes(os.urandom(4), "big")
    if isinstance(seed_setting, int):
        return seed_setting
    if isinstance(seed_setting, str) and seed_setting.isdigit():
        return int(seed_setting)
    digest = hashlib.sha512(str(seed_setting).encode()).digest()
    return int.from_bytes(digest, "big") % 0x100000000


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but CUDA is not available")
    return device


class Engine:
    """``state_dicts`` optionally maps perceptor names to OpenAI-layout
    weights (see ``models/clip/bridge.py``); others get seeded random weights."""

    def __init__(self, args, device="cuda", state_dicts=None):
        self.args = args
        self.device = resolve_device(device)
        for name, off in _UNPORTED:
            if getattr(args, name, off) not in (off, None, [], 0, False):
                raise NotImplementedError(f"setting {name}={getattr(args, name)!r} is not yet ported")
        if args.init_noise not in (None, "pixels"):
            raise NotImplementedError(f"init_noise {args.init_noise!r} is not yet ported")

        self.seed_used = resolve_seed(args.seed)
        print("Using seed:", self.seed_used)
        int_seed = int(self.seed_used) % (2**30)
        np.random.seed(int_seed)
        random.seed(int_seed)
        self.np_rng = np.random.default_rng(int_seed)
        # small draws (cut geometry, jitter, fill, init colors) on the host;
        # the noise planes on the device
        self.gen = torch.Generator().manual_seed(int_seed)
        self.gen_device = torch.Generator(device=self.device).manual_seed(int_seed)

        # ---- drawer
        self.drawer = drawer_class(args.drawer)(args)
        self.side_x, self.side_y = self.drawer.snap_canvas(args.size)

        # ---- precision
        on_cuda = self.device.type == "cuda"
        tower_dtype = torch.bfloat16 if (args.precision == "bf16" and on_cuda) else torch.float32
        self.compute_dtype = torch.bfloat16 if on_cuda else None

        # ---- perceptors + text prompt tables
        state_dicts = state_dicts or {}
        self.perceptors = [Perceptor(name, self.device, tower_dtype, state_dicts.get(name))
                           for name in args.clip_models]
        tables = build_prompt_tables(args, self.perceptors, self.device)

        # ---- init latent (the stroke drawers ignore init_tensor and make
        # their model_params here)
        init_tensor = None
        if args.init_noise == "pixels":
            init_tensor = _uint8_to_unit(self._init_noise(args)) * 2 - 1
        self.z = tree_map(lambda t: t.to(self.device), self.drawer.init_params(self.gen, init_tensor))
        self.z_orig_flat = ravel(self.z).clone()
        self.drawer_params = {k: v.to(self.device) for k, v in self.drawer.model_params.items()}

        self.step_cfg = StepConfig(
            drawer=self.drawer,
            drawer_params=self.drawer_params,
            perceptors=[
                PerceptorSpec(p.name, p.input_resolution, p.image_fn, tables[p.name])
                for p in self.perceptors
            ],
            batches=args.batches,
            transparent=args.transparent,
            transparent_weight=args.transparent_weight,
            init_weight=args.init_weight,
            init_weight_dist=args.init_weight_dist,
            init_weight_cos=args.init_weight_cos,
            z_orig_flat=self.z_orig_flat,
            compute_dtype=self.compute_dtype,
        )
        self.loss_names = self.step_cfg.names

        self.tracker = BestTracker(max_loss_drops=args.max_loss_drops)
        self._build_optimizer()

        self.cur_iteration = 0
        self.last_loss_values = None
        self._pending_loss = None
        print("Optimising using:", args.optimiser)
        if args.prompts:
            print("Using text prompts:", args.prompts)

    def _build_optimizer(self):
        """The drawer's own optimizer (``get_opts``) or the engine-global one."""
        get_opts = getattr(self.drawer, "get_opts", None)
        drawer_opt = get_opts(self.args, 1.0) if get_opts is not None else None
        if drawer_opt is not None:
            self.optimizer = drawer_opt
        else:
            drawer_lr = getattr(self.drawer, "learning_rate", None)
            lr = drawer_lr if drawer_lr is not None else self.args.learning_rate
            self.optimizer = build_optimizer(self.args.optimiser, lr)
        self.opt_state = self.optimizer.init(self.z)
        self.lr_scale = 1.0 / self.tracker.drop_divisor

    def _init_noise(self, args):
        from pixray_tpu_torch.utils.noise import random_noise_array

        arr = random_noise_array(args.size[0], args.size[1], self.np_rng)
        if arr.shape[:2] != (self.side_y, self.side_x):
            raise NotImplementedError("init noise resizing is not yet ported")
        return arr

    # ------------------------------------------------------------------ draws
    def draw_step(self) -> list[dict]:
        """One draws dict per batch of the next step (see ``step.loss_fn``)."""
        out = []
        for _ in range(self.args.batches):
            fill = float(torch.rand((), generator=self.gen))
            out.append({
                "fill": fill,
                "perceptors": [
                    C.draw_step_cutouts(self.gen, self.gen_device, self.args.num_cuts,
                                        p.input_resolution, self.args.aspect_width,
                                        self.compute_dtype or torch.float32, self.device)
                    for p in self.perceptors
                ],
            })
        return out

    # ------------------------------------------------------------------ train/run
    def train(self, cur_it: int, draws=None) -> bool:
        """One optimizer step + host scheduling; False when the run should end.

        ``draws`` (one dict per batch) replaces this step's random draws."""
        args = self.args
        rebuild_opts_when_done = False

        if cur_it < args.iterations:
            batch_draws = self.draw_step() if draws is None else draws
            self.z, self.opt_state, total, values, _img = train_step(
                self.step_cfg, self.optimizer, self.z, self.opt_state, cur_it, self.lr_scale,
                batch_draws,
            )
            self.last_loss_values = values

            if cur_it in args.learning_rate_drops:
                print("Dropping learning rate")
                rebuild_opts_when_done = True
            else:
                # read the PREVIOUS step's loss: it is finished by now, so the
                # host does not wait on the step it just queued
                if self._pending_loss is not None:
                    p_it, p_total = self._pending_loss
                    did_drop = self.tracker.check(p_it, float(p_total))
                    if args.auto_stop is True:
                        rebuild_opts_when_done = did_drop
                self._pending_loss = (cur_it, total)

            if cur_it % args.save_every == 0:
                self.checkin(cur_it, values)

        if cur_it == args.iterations:
            self.checkin(cur_it, self.last_loss_values)
            return False
        if rebuild_opts_when_done:
            if not self.tracker.register_drop(cur_it):
                return False
            self.opt_state = self.optimizer.init(self.z)
            self.lr_scale = 1.0 / self.tracker.drop_divisor
        return True

    @torch.no_grad()
    def synth_array(self) -> np.ndarray:
        arr = self.drawer.synth(self.drawer_params, self.z).float().cpu().numpy()
        if arr.shape[-1] == 4 and not self.args.transparent:
            arr = arr[..., :3]
        return arr

    def checkin(self, it: int, values):
        args = self.args
        if values is not None:
            vals = values.float().cpu().numpy()
            losses_str = ", ".join(f"{v:2.3g}" for v in vals)
            writestr = f"iter: {it}, loss: {vals.sum():1.3g}, losses: {losses_str}"
        else:
            writestr = f"iter: {it}, finished"
        stale = it - self.tracker.best_iter
        writestr = f"{writestr} (-{stale}=>{self.tracker.best_loss:2.4g})"
        arr = self.synth_array()
        outfile = get_file_path(args.outdir, args.output, ".png")
        OUT.save_png(arr, outfile, OUT.png_text(args.given_args, self.seed_used))
        if args.save_intermediates:
            step_path = os.path.join(args.outdir, "steps")
            os.makedirs(step_path, exist_ok=True)
            OUT.save_png(arr, get_file_path(step_path, f"frame_{it:04d}", ".png"))
        print(writestr)

    def run(self) -> bool:
        """Train until ``iterations`` (the final checkin included)."""
        args = self.args
        keep_going = True
        while keep_going:
            keep_going = self.train(self.cur_iteration)
            if self.cur_iteration == args.iterations:
                break
            self.cur_iteration += 1
        if args.save_svg:
            self.save_svg()
        return True

    def save_svg(self):
        """Vector export for drawers that have one (clipdraw, line_sketch)."""
        to_svg = getattr(self.drawer, "to_svg", None)
        if to_svg is None:
            print(f"drawer {self.args.drawer} has no SVG export")
            return None
        outfile = get_file_path(self.args.outdir, self.args.output, ".svg")
        with open(outfile, "w") as f:
            f.write(to_svg(self.z))
        print(f"saved {outfile}")
        return outfile


def _uint8_to_unit(arr: np.ndarray) -> torch.Tensor:
    """uint8 (H, W, 3) → float32 [0, 1] tensor (the JAX package's ``to_tensor``)."""
    return torch.from_numpy(np.asarray(arr, dtype=np.float32) / 255.0)
