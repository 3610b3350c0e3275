"""Engine: session init and the host-side run loop (port of ``pixray_tpu/engine/core.py``).

``Engine(settings, device)`` seeds the run, builds the drawer, the
perceptors and their prompt tables, and runs ``train``/``checkin``/``run``
with the JAX engine's cadence (checkin at ``save_every`` and at the end,
LR drops with a fresh optimizer state, best-loss tracking read one step
late so the host never waits on the step it just queued).

Blocked dispatch, as the JAX engine runs it (``--steps_per_call``: 0 means
blocks of 8 steps, 1 single steps, N > 1 blocks of N): between host events
(checkins, LR drops) ``_block_size`` groups the steps into full-size
blocks, and a block is one dispatch, ``step.StepBlock``: one replay of a
captured CUDA graph of its steps on the card, its steps in a loop on the
CPU.  The host draws a block's steps in the eager order, so a blocked run
draws exactly what a single-step run draws; it dispatches the next block
before it reads the current block's losses (in one transfer), unless a
host event comes between.  ``train(cur_it, draws=...)`` with explicit
draws is always one eager step.  On the card ``--steps_per_call 1`` is the
only way to the eager step.

``device`` is explicit and defaults to ``"cuda"``; asking for CUDA where
there is none raises (there is no CPU fallback).  The towers and the VQGAN
compute in bfloat16 on CUDA when ``--precision bf16`` (the default), the
post-warp epilogue in bfloat16 on CUDA; all in float32 on the CPU.

The latent is a tensor (pixel, vqgan) or a dict of tensors (clipdraw,
line_sketch); a drawer with ``load_model`` gets the device and dtype for
its weights; a drawer with ``get_opts`` brings its own optimizer (one Adam
per group), as in the JAX engine.  ``--init_noise pixels`` off the
drawer's grid is resized with PIL's Lanczos, as in the JAX engine.
``run`` ends, also after an interrupt, with the step video of the checkin
frames (``--save_intermediates``) and ``--save_svg``'s vector export.

``--filters`` (``name:weight``, comma-separated) and ``--custom_loss``
(``name:weight``, ``loss->arg->arg``) are built as the JAX engine builds
them, with the losses' ``add_globals``.  Each step's draws are, per batch,
the fill, then each filter's shifts (over the shape the filters before it
leave), then the perceptors' cuts: a run without filters draws exactly
what it drew before filters were ported.

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
from pixray_tpu_torch.engine.step import (PerceptorSpec, StepBlock, StepConfig, draws_to_inputs, pack_step,
                                          train_step)
from pixray_tpu_torch.filters import filter_class
from pixray_tpu_torch.io import output as OUT
from pixray_tpu_torch.losses import loss_class
from pixray_tpu_torch.models.perceptor import Perceptor
from pixray_tpu_torch.prompt import parse_prompt
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
BLOCK_STEPS = 8  # --steps_per_call 0: blocks of 8 steps, as in the JAX engine


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
    weights (see ``models/clip/bridge.py``) and the drawer's name to its
    weights (``"vqgan"``: taming names, see ``models/vqgan.py``); the rest
    load from their checkpoint files or get seeded random weights."""

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

        # ---- precision: the towers and a drawer's model compute in bf16 on
        # CUDA under --precision bf16; the epilogue in bf16 on CUDA
        on_cuda = self.device.type == "cuda"
        model_dtype = torch.bfloat16 if (args.precision == "bf16" and on_cuda) else torch.float32
        self.compute_dtype = torch.bfloat16 if on_cuda else None

        # ---- drawer (a drawer with weights loads them before snapping)
        state_dicts = state_dicts or {}
        self.drawer = drawer_class(args.drawer)(args)
        load_model = getattr(self.drawer, "load_model", None)
        if load_model is not None:
            load_model(args, self.device, model_dtype, state_dicts.get(args.drawer))
        self.side_x, self.side_y = self.drawer.snap_canvas(args.size)

        # ---- perceptors + text prompt tables
        self.perceptors = [Perceptor(name, self.device, model_dtype, state_dicts.get(name))
                           for name in args.clip_models]
        tables = build_prompt_tables(args, self.perceptors, self.device)

        # ---- filters and custom losses ("name:weight", "loss->arg->arg")
        self.filters = []
        if args.filters is not None:
            for spec in [f.strip() for f in args.filters.split(",")]:
                name, weight, _stop = parse_prompt(spec)
                try:
                    filt_cls = filter_class(name)
                except KeyError:
                    raise ValueError(f"Requested filter not found, aborting: {name}") from None
                self.filters.append((filt_cls(args), weight))
        self.custom_losses = []
        self.loss_globals = {}
        if args.custom_loss is not None and isinstance(args.custom_loss, str):
            for chunk in [c.strip() for c in args.custom_loss.split(",")]:
                loss_spec, *instance_args = chunk.split("->") if chunk.find("->") > 0 else [chunk]
                name, weight, _stop = parse_prompt(loss_spec)
                loss_obj = loss_class(name)(args)
                loss_obj.instance_settings(instance_args)
                self.custom_losses.append((loss_obj, weight))
            for loss_obj, _w in self.custom_losses:
                self.loss_globals.update(loss_obj.add_globals(args))

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
            filters=self.filters,
            custom_losses=self.custom_losses,
            loss_globals=self.loss_globals,
            args=args,
        )
        self.loss_names = self.step_cfg.names

        self.tracker = BestTracker(max_loss_drops=args.max_loss_drops)
        self._build_optimizer()

        self.cur_iteration = 0
        self.last_loss_values = None
        self._pending_loss = None
        self._block = None  # the dispatched block being walked, and the one after it
        self._next_block = None
        self.step_block = None  # the StepBlock (its graph, once captured), made at the first block
        self._display_streaming = False  # run() streams no partial results (not ported)
        self.steps_dispatched = 0  # steps whose work has been enqueued, blocked or eager
        self.dispatched_blocks = []  # (first step, steps) of every block dispatched
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
        # a device tensor: a captured block reads it, and an LR drop fills it
        self.lr_scale = torch.full((), 1.0 / self.tracker.drop_divisor, dtype=torch.float32, device=self.device)

    def _init_noise(self, args):
        from pixray_tpu_torch.utils.noise import random_noise_array

        arr = random_noise_array(args.size[0], args.size[1], self.np_rng)
        if arr.shape[:2] != (self.side_y, self.side_x):
            # off the drawer's grid: PIL's Lanczos, as the JAX engine resizes
            # (PIL is imported only here, so an on-grid run never needs it)
            from PIL import Image

            arr = np.asarray(Image.fromarray(arr).resize((self.side_x, self.side_y), Image.LANCZOS))
        return arr

    # ------------------------------------------------------------------ draws
    def draw_step(self, planes_out=None) -> list[dict]:
        """One draws dict per batch of the next step (see ``step.pack_step``),
        drawn in the order fill, filter shifts (each in the range of the
        shape the filters before it leave), cuts; ``planes_out`` (per batch,
        per perceptor: three planes) receives the noise planes."""
        out = []
        for b in range(self.args.batches):
            fill = float(torch.rand((), generator=self.gen))
            shifts, h, w = [], self.side_y, self.side_x
            for filt, _weight in self.filters:
                shifts.append(filt.draw(self.gen, h, w))
                h, w = filt.out_shape(h, w)
            out.append({
                "fill": fill,
                "filters": shifts,
                "perceptors": [
                    C.draw_step_cutouts(self.gen, self.gen_device, self.args.num_cuts,
                                        p.input_resolution, self.args.aspect_width,
                                        self.compute_dtype or torch.float32, self.device,
                                        planes_out=None if planes_out is None else planes_out[b][i])
                    for i, p in enumerate(self.perceptors)
                ],
            })
        return out

    # ------------------------------------------------------------------ blocks
    def _want(self) -> int:
        return BLOCK_STEPS if self.args.steps_per_call == 0 else self.args.steps_per_call

    def _block_size(self, cur_it: int) -> int:
        """How many steps may run as one dispatch starting at ``cur_it`` (the
        JAX engine's rules): post-step host events (checkin, LR drop,
        checkpoint, display streaming) may fall only on a block's last step;
        ``auto_stop``, ``--video`` and a drawer with ``post_step`` disable
        blocking; ``--steps_per_call 1`` forces single steps."""
        args = self.args
        if getattr(args, "steps_per_call", 0) == 1:
            return 1
        n = self._want()
        if args.make_video or args.auto_stop or hasattr(self.drawer, "post_step"):
            return 1
        n = min(n, args.iterations - cur_it)
        # (animation, which caps a block at its frame's span, is not ported)
        if n < 2:
            return 1
        for it in range(cur_it, cur_it + n - 1):  # post-step events: all but the last step
            if it % args.save_every == 0 or it in args.learning_rate_drops:
                n = it - cur_it + 1
                break
            ck = getattr(args, "checkpoint_every", 0)
            if ck and it and it % ck == 0:
                n = it - cur_it + 1
                break
            de = args.display_every
            if self._display_streaming and de and (it + 1) % de == 0:
                n = it - cur_it + 1
                break
        # (pre-step events inside a block: the overlay, which is not ported)
        return max(n, 1)

    def _has_host_event(self, it: int) -> bool:
        """Host work is due after step ``it`` (checkin, LR drop, checkpoint,
        display), so no block may be dispatched past it: those paths read
        the latent of step ``it``.  The display test is the JAX engine's."""
        args = self.args
        if it % args.save_every == 0 or it in args.learning_rate_drops:
            return True
        ck = getattr(args, "checkpoint_every", 0)
        if ck and it and it % ck == 0:
            return True
        de = args.display_every
        return bool(de and (it + 1) % de == 0)

    def _dispatch_block(self, cur_it: int, n: int) -> dict:
        """Draw, stage and dispatch ``n`` steps from ``cur_it``; the losses stay pending."""
        blk = self.step_block
        if blk is None or blk.n != n:
            blk = self.step_block = StepBlock(self.step_cfg, self.optimizer, n,
                                               [self.args.num_cuts] * len(self.perceptors), self.device)
        rows, ints = blk.staging_inputs()
        for s in range(n):
            pack_step(self.step_cfg, self.draw_step(planes_out=blk.plane_targets(s)), cur_it + s, rows[s], ints[s])
        blk.upload()
        result = blk.run(self.z, self.opt_state, self.lr_scale)
        self.steps_dispatched += n
        self.dispatched_blocks.append((cur_it, n))
        return {"start": cur_it, "n": n, "result": result, "totals": None, "valss": None}

    def _consume_block(self, cur_it: int):
        """(total, values) of step ``cur_it`` from the dispatched block, or None.

        At a block's first step the next block is dispatched, when no host
        event comes between them, before this block's losses (n,) and (n,
        L) come to the host in one transfer."""
        b = self._block
        if b is None:
            return None
        idx = cur_it - b["start"]
        if not 0 <= idx < b["n"]:
            self._block = self._next_block = None
            return None
        if idx == 0 and b["totals"] is None:
            want = self._want()
            nxt = b["start"] + b["n"]
            # (the JAX engine also stops at an overlay due at nxt: not ported)
            if (self._next_block is None and not self._has_host_event(nxt - 1)
                    and self._block_size(nxt) == want and want > 1):
                self._next_block = self._dispatch_block(nxt, want)
            b["totals"], b["valss"] = b["result"].host()
        total, values = b["totals"][idx], b["valss"][idx]
        if idx == b["n"] - 1:
            self._block, self._next_block = self._next_block, None
        return total, values

    # ------------------------------------------------------------------ train/run
    def train(self, cur_it: int, draws=None) -> bool:
        """One optimizer step + host scheduling; False when the run should end.

        The step comes from a dispatched block where one covers ``cur_it``
        (a full-size block is dispatched here when ``_block_size`` allows
        one), else it runs eagerly.  ``draws`` (one dict per batch) replaces
        this step's random draws and makes it one eager step."""
        args = self.args
        rebuild_opts_when_done = False

        if cur_it < args.iterations:
            buffered = None
            if draws is None:
                buffered = self._consume_block(cur_it)
                if buffered is None:
                    # only full-size blocks run blocked (one captured graph);
                    # a truncated span runs single steps
                    n = self._block_size(cur_it)
                    if n == self._want() and n > 1:
                        self._block = self._dispatch_block(cur_it, n)
                        buffered = self._consume_block(cur_it)
            if buffered is not None:
                total, values = buffered
            else:
                batch_draws = self.draw_step() if draws is None else draws
                inputs = draws_to_inputs(self.step_cfg, batch_draws, cur_it, self.device)
                total, values, _img = train_step(self.step_cfg, self.optimizer, self.z, self.opt_state,
                                                 self.lr_scale, inputs)
                self.steps_dispatched += 1
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
            # in place: a captured block reads the state and the scale where they are
            self.optimizer.reset(self.opt_state)
            self.lr_scale.fill_(1.0 / self.tracker.drop_divisor)
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
        """Train until ``iterations`` (the final checkin included), or until
        interrupted; then the step video and the SVG."""
        args = self.args
        try:
            keep_going = True
            while keep_going:
                keep_going = self.train(self.cur_iteration)
                if self.cur_iteration == args.iterations:
                    break
                self.cur_iteration += 1
        except KeyboardInterrupt:
            pass
        if args.save_intermediates:
            OUT.step_to_video(args)
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
