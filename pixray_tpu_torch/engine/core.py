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
draws is always one eager step.  On the card ``--steps_per_call 1`` (or a
gloo mesh, below) is the only way to the eager step.

``device`` is explicit and defaults to ``"cuda"``; asking for CUDA where
there is none raises (there is no CPU fallback).  The towers compute in
bfloat16 when ``--precision bf16`` (the default), on the CPU too, as the
JAX engine's do; the VQGAN and the losses' networks in bfloat16 on CUDA
under it, and the post-warp epilogue in bfloat16 on CUDA; the rest in
float32.  The precision rungs (``config/precision.py``: K1's and K2's,
the towers' int8 and LayerNorm rungs) are read from the environment when
the engine is built.

The latent is a tensor (pixel, vqgan, vdiff, super_resolution, ...) or a
dict of tensors (clipdraw, line_sketch); a drawer with ``load_model`` gets
the device and dtype for its weights; a drawer with ``get_opts`` brings
its own optimizer (one Adam per group), as in the JAX engine.  A drawer
with ``set_clip_embed`` (vdiff's cc12m models) gets the weighted prompt
embedding of the perceptor it names; one with ``post_step`` (vdiff) runs
every step eager, re-noises the latent after it and starts a fresh
optimizer at its own rate.  ``synth`` takes the iteration (a () device
tensor in the step, the engine's iteration at a checkin).
``--init_noise pixels`` off the drawer's grid is resized with PIL's
Lanczos, as in the JAX engine.
``run`` ends, also after an interrupt, with ``--make_video``'s video of
the per-step frames, the step video of the checkin frames
(``--save_intermediates``) and ``--save_svg``'s vector export; with
``return_display`` it returns False every ``display_every`` steps, so a
caller can stream partial results, and ``--profile_dir`` traces the run
(``engine/profiling.py``).

``--filters`` (``name:weight``, comma-separated) and ``--custom_loss``
(``name:weight``, ``loss->arg->arg``) are built as the JAX engine builds
them, with the losses' ``add_globals``.  Each step's draws are, per batch,
the fill, then each filter's shifts (over the shape the filters before it
leave), then per perceptor its cuts and the noise of the banks that reuse
them (``cutouts.draw_step_cutouts``), and after all batches each
batch's custom-loss draws (``style``'s, ``draw_layout``): a run without
filters, spot or image prompts or a drawing loss draws exactly what it
drew before those were ported.  A loss with weights (``style``'s VGG16,
``resmem``'s network) gets the engine's device and model dtype through
``place``; a loss with a gate (``host_active``) is left out of an eager
step, or a block, in which the gate is off at every step (the block is
captured for that set of losses: at most one graph per set).

The image inputs, as the JAX engine reads them (PIL is imported only for
them): ``--init_image`` (the last of its files, resized with Lanczos, is
the init latent and ``--init_weight_pix``'s reference; the init noise is
drawn all the same, and ``--init_image_alpha`` shapes only the
animation's frames), ``--init_noise
gradient|snow``, ``--overlay_image`` (its first file, pasted over the canvas and re-encoded into the latent before each step
``apply_overlay`` names: a pre-step host event, which ends the block
before it; the latent's tensors are written in place, and Adam's state
is kept), ``--image_labels`` (the normalized mean of the encoded images,
an ``image_label0`` term), ``--target_images``, ``--image_prompts``
(pooled to each tower's work canvas once per run), ``--spot_prompts`` and
``--spot_prompts_off`` (the spot mask at the work canvas's size).

The animation ring (``--animation_dir``, as the JAX engine runs it): the
frame list is the longest of the overlay, target, init and prompt image
lists; each round runs every frame for ``save_every`` steps from its own
latent, copied into the latent's tensors at the frame's start and back
out after its span (a captured block reads them where they are), with
one optimizer state across the frames; between rounds each frame is
blended with the previous one (``--animation_alpha``) and re-encoded.
The frame's index reaches the step as a device int32 in the block's
inputs (its target row and image prompt are picked on the device); a
block never crosses a frame's span.  A frame's first step applies its
init image and overlay, its checkins write its PNG, and the last frame's
checkin writes ``anim.gif``.

Session checkpoints (``engine/checkpoint.py``): ``--checkpoint_every N``
writes ``outdir/session.ckpt`` after every N-th step, ``--resume_from``
restores one (the port's, or the JAX engine's) into the new engine.

The mesh (``parallel/mesh.py``): under ``--shard_cutouts`` the engine
joins the process group the environment configures and lays
``--mesh_shape`` over all of its ranks, one device each (plain ``"cuda"``
is the rank's card), padding ``num_cuts`` to the data axis.  Every rank
seeds and draws the whole step as one process would; the step
(``engine/step.py``) splits the work and sums it, and only rank 0 writes
files.  Under a mesh the engine dispatches blocks as it does unsharded,
except where the step's collectives cannot sit in a CUDA graph: on the
CPU (gloo) a block is its steps in a loop; on the card over NCCL one
replay of a graph that holds every collective of its steps; on the card
over gloo (ranks sharing one card) every step is eager (``--steps_per_call``
becomes 1; ``mesh.step_capturable``).
"""

from __future__ import annotations

import hashlib
import os
import random

import numpy as np
import torch

from pixray_tpu_torch.config.precision import read_rungs
from pixray_tpu_torch.drawers import drawer_class
from pixray_tpu_torch.engine import cutouts as C
from pixray_tpu_torch.engine.latent import leaves, ravel, tree_map
from pixray_tpu_torch.engine.optimizers import build_optimizer
from pixray_tpu_torch.engine.prompts import build_prompt_tables
from pixray_tpu_torch.engine.schedule import BestTracker, apply_overlay
from pixray_tpu_torch.engine.step import (PerceptorSpec, StepBlock, StepConfig, bank_rows, draws_to_inputs,
                                          pack_step, train_step)
from pixray_tpu_torch.filters import filter_class
from pixray_tpu_torch.io import images as IM
from pixray_tpu_torch.io import output as OUT
from pixray_tpu_torch.losses import loss_class
from pixray_tpu_torch.models.perceptor import Perceptor
from pixray_tpu_torch.parallel import ensemble as PE
from pixray_tpu_torch.parallel import mesh as PM
from pixray_tpu_torch.prompt import parse_prompt
from pixray_tpu_torch.utils import get_file_path, real_glob

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
    """``device`` as a torch device; in a process group (one rank's too),
    plain ``"cuda"`` is the rank's card, ``cuda:{local rank % cards}``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but CUDA is not available")
    if device.type == "cuda" and device.index is None and torch.distributed.is_initialized():
        device = torch.device("cuda", PM.local_rank() % torch.cuda.device_count())
    return device


def mesh_dispatch(args, mesh, device) -> str:
    """Under a mesh, blocks as unsharded, unless the step's collectives
    cannot sit in a CUDA graph: on the card over gloo (ranks sharing one
    card) every step is eager, and ``args.steps_per_call`` becomes 1.  On
    the CPU a block is its steps in a loop; on the card over NCCL one graph
    replay with the collectives inside.  Returns the backend and the
    dispatch, in words."""
    backend = torch.distributed.get_backend(mesh.group)
    if torch.device(device).type == "cuda" and not PM.step_capturable(mesh):
        args.steps_per_call = 1  # a gloo collective runs on the host, outside any graph
        return f"{backend}: eager steps, --steps_per_call 1"
    return f"{backend}: blocks as unsharded"


class Engine:
    """``state_dicts`` optionally maps perceptor names to OpenAI-layout
    weights (see ``models/clip/bridge.py``) and the drawer's name to its
    weights (``"vqgan"``: taming names, see ``models/vqgan.py``); the rest
    load from their checkpoint files or get seeded random weights.
    ``mesh``: a prebuilt ``parallel.mesh.Mesh`` (the dry run's), else the
    settings' (:meth:`_build_mesh`)."""

    def __init__(self, args, device="cuda", state_dicts=None, mesh=None):
        self.args = args
        self.mesh = self._build_mesh(args, device) if mesh is None else mesh
        if self.mesh is not None:
            padded = PM.pad_cuts_for_mesh(args.num_cuts, self.mesh)
            if padded != args.num_cuts:
                print(f"padding num_cuts {args.num_cuts} -> {padded} for the {self.mesh.shape} mesh")
                args.num_cuts = padded
        self.writer = self.mesh is None or self.mesh.rank == 0  # under a mesh, rank 0 writes the files
        self.device = resolve_device(device)
        if self.mesh is not None:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            print(f"Using device mesh {self.mesh.shape} for cutout data-parallelism "
                  f"({mesh_dispatch(args, self.mesh, self.device)})")
        if args.init_weight_pix and not args.init_image:
            raise ValueError("init_weight_pix needs an init_image")

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

        # ---- precision: the towers compute in bf16 under --precision bf16
        # (as the JAX engine's, on any device), a drawer's model and the
        # losses' networks in bf16 on CUDA under it; the epilogue in bf16 on
        # CUDA; the rungs (config/precision.py) read here, once per engine
        on_cuda = self.device.type == "cuda"
        model_dtype = torch.bfloat16 if (args.precision == "bf16" and on_cuda) else torch.float32
        tower_dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
        self.compute_dtype = torch.bfloat16 if on_cuda else None
        self.rungs = read_rungs()

        # ---- drawer (a drawer with weights loads them before snapping)
        state_dicts = state_dicts or {}
        self.drawer = drawer_class(args.drawer)(args)
        load_model = getattr(self.drawer, "load_model", None)
        if load_model is not None:
            load_model(args, self.device, model_dtype, state_dicts.get(args.drawer))
        self.side_x, self.side_y = self.drawer.snap_canvas(args.size)

        self.perceptors = [Perceptor(name, self.device, tower_dtype, state_dicts.get(name), self.rungs)
                           for name in args.clip_models]
        ensemble = PE.ensemble_active(self.mesh, len(self.perceptors))
        if ensemble:
            print(f"Placing {len(self.perceptors)} perceptors on {self.mesh.shape[PM.MODEL_AXIS]} model-axis "
                  "device groups (one member per group)")

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
                place = getattr(loss_obj, "place", None)
                if place is not None:  # frozen weights on the engine's device, in the towers' dtype
                    place(self.device, model_dtype, state_dicts.get(name))
                self.custom_losses.append((loss_obj, weight))
            for loss_obj, _w in self.custom_losses:
                self.loss_globals.update(loss_obj.add_globals(args))

        # ---- init latent from the init image or noise (the stroke drawers
        # ignore init_tensor and make their model_params here)
        init_tensor = self._init_tensor(args)
        self.z = tree_map(lambda t: t.to(self.device), self.drawer.init_params(self.gen, init_tensor))
        self.z_orig_flat = ravel(self.z).clone()
        self.drawer_params = {k: v.to(self.device) for k, v in self.drawer.model_params.items()}

        self.overlay_image_rgba_list = []
        self.overlay_image_rgba = None
        if args.overlay_image is not None:
            from PIL import Image

            for overlay_image in IM.open_images(args.overlay_image):
                rgba = overlay_image.convert("RGBA").resize((self.side_x, self.side_y), Image.LANCZOS)
                if args.overlay_alpha:
                    rgba.putalpha(args.overlay_alpha)
                self.overlay_image_rgba_list.append(rgba)
            self.overlay_image_rgba = self.overlay_image_rgba_list[0]

        # ---- image labels → the normalized mean of their latents
        self.z_labels = []
        if args.image_labels is not None:
            labels = []
            for path in real_glob(args.image_labels):
                rgb = torch.from_numpy(IM.load_image_rgb(path, (self.side_x, self.side_y)))
                labels.append(ravel(self.drawer.params_from_image(rgb.to(self.device) * 2 - 1)).float().cpu().numpy())
            stacked = np.stack(labels)
            stacked = stacked / np.linalg.norm(stacked, axis=-1, keepdims=True)
            mean = stacked.mean(axis=0)
            self.z_labels = [torch.from_numpy(mean / np.linalg.norm(mean)).to(self.device)]

        # ---- prompt tables (target images encoded once)
        target_specs = None
        if args.target_images:
            target_specs = []
            for target_image in args.target_images:
                f1, weight, stop = parse_prompt(target_image)
                if "http" in f1:
                    target_specs.append((f1, weight, stop))
                else:
                    target_specs.extend((f, weight, stop) for f in real_glob(f1))
        tables, spot_tables, spot_off_tables, target_tables, clip_embed = build_prompt_tables(
            args, self.perceptors, self.device, target_image_paths=target_specs, drawer=self.drawer)
        if clip_embed is not None and hasattr(self.drawer, "set_clip_embed"):
            self.drawer.set_clip_embed(clip_embed)
            self.drawer_params.update({k: v.to(self.device) for k, v in self.drawer.model_params.items()})

        # ---- image prompts at the canvas size, (H, W, 3) on the device
        self.image_prompt_images = []
        for path in args.image_prompts or []:
            from PIL import Image

            pil = IM.resize_area_preserving(IM.open_image(path).convert("RGB"), (self.side_x, self.side_y))
            pil = pil.resize((self.side_x, self.side_y), Image.LANCZOS)
            self.image_prompt_images.append(torch.from_numpy(IM.to_tensor(pil)).to(self.device))

        # FSDP (one tower, a model axis > 1): each rank keeps its shard of
        # the vision tower's weights from here on (the tables are encoded)
        fsdp = [] if ensemble else [w for w in (PM.shard_perceptor_params(p.model.visual, self.mesh)
                                                for p in self.perceptors) if w is not None]
        self.step_cfg = StepConfig(
            drawer=self.drawer,
            drawer_params=self.drawer_params,
            perceptors=[
                PerceptorSpec(p.name, p.input_resolution, p.image_fn, tables[p.name],
                              spot_table=spot_tables[p.name], spot_off_table=spot_off_tables[p.name],
                              image_prompt_weight=args.image_prompt_weight, target_table=target_tables[p.name],
                              image_prompt_frame=bool(args.animation_dir), affine_fn=p.preprocess_affine,
                              **self._image_prompt_inputs(args, p))
                for p in self.perceptors
            ],
            batches=args.batches,
            transparent=args.transparent,
            transparent_weight=args.transparent_weight,
            init_weight=args.init_weight,
            init_weight_dist=args.init_weight_dist,
            init_weight_cos=args.init_weight_cos,
            init_weight_pix=args.init_weight_pix,
            image_label_weight=args.image_label_weight,
            image_prompt_shuffle=args.image_prompt_shuffle,
            z_orig_flat=self.z_orig_flat,
            init_image=self.init_image_tensor,
            z_labels=self.z_labels,
            compute_dtype=self.compute_dtype,
            warp_prec=self.rungs.warp,
            warp_bwd=self.rungs.warp_bwd,
            filters=self.filters,
            custom_losses=self.custom_losses,
            loss_globals=self.loss_globals,
            loss_layouts=[getattr(loss_obj, "draw_layout", lambda h, w: [])(*self._loss_canvas())
                          for loss_obj, _w in self.custom_losses],
            args=args,
            mesh=self.mesh,
            ensemble=ensemble,
            fsdp=fsdp,
        )
        self.loss_names = self.step_cfg.names

        self.tracker = BestTracker(max_loss_drops=args.max_loss_drops)
        self._build_optimizer()

        self.cur_iteration = 0
        self.last_loss_values = None
        self._pending_loss = None
        self._block = None  # the dispatched block being walked, and the one after it
        self._next_block = None
        self.step_block = None  # the last StepBlock dispatched (its graph, once captured)
        self.step_blocks = {}  # StepBlocks by (steps, custom losses left out)
        self._display_streaming = False  # run(return_display=True) sets this
        self.steps_dispatched = 0  # steps whose work has been enqueued, blocked or eager
        self.dispatched_blocks = []  # (first step, steps) of every block dispatched
        self.cur_anim_index = None  # the animation frame being trained, or None
        self.anim_output_files = []
        self.anim_cur_zs = []

        if args.resume_from:
            from pixray_tpu_torch.engine.checkpoint import restore_session

            it = restore_session(args.resume_from, self)
            print(f"Resumed session from {args.resume_from} at iteration {it}")
        print("Optimising using:", args.optimiser)
        if args.prompts:
            print("Using text prompts:", args.prompts)
        if args.spot_prompts:
            print("Using spot prompts:", args.spot_prompts)
        if args.image_prompts:
            print("Using image prompts:", args.image_prompts)
        if args.init_image:
            print(f"Using initial image {args.init_image} ({len(self.init_image_rgba_list)})")

    @staticmethod
    def _build_mesh(args, device):
        """Under ``--shard_cutouts``: join the process group the environment
        configures (``parallel.mesh.init_distributed``, gloo for a CPU
        ``device``) and build
        ``--mesh_shape``'s mesh over every rank of it; None for one rank.
        A shape that cannot be built, or one that leaves ranks out, raises
        (the JAX engine prints "mesh setup skipped" and runs unsharded)."""
        if not args.shard_cutouts:
            return None
        if PM.init_distributed(device=device):
            rank, n = PM.world()
            print(f"Joined process group: rank {rank}/{n} ({torch.distributed.get_backend()})")
        mesh = PM.build_mesh(args.mesh_shape)
        n = PM.world()[1]
        if (1 if mesh is None else mesh.size) != n:
            raise ValueError(f"mesh_shape {args.mesh_shape!r} does not span the {n} ranks of the process group")
        return mesh

    def _init_tensor(self, args):
        """The drawer's init image in [-1, 1] on the host, or None: the last
        init image, else the init noise (drawn under an init image too, as
        the JAX engine draws it).  Sets ``init_image_tensor``: the last init
        image in [0, 1] on the device, or None; and ``init_image_rgba_list``:
        per init image, the image at ``--init_image_alpha`` over the init
        noise (the animation's frames start from them)."""
        self.init_image_tensor = None
        self.init_image_rgba_list = []
        if not (args.init_image or args.init_noise):
            return None
        starting = self._init_noise(args)
        if not args.init_image:
            return _uint8_to_unit(starting) * 2 - 1
        from PIL import Image

        size = (self.side_x, self.side_y)
        for init_image in IM.open_images(args.init_image):
            rgb = IM.to_tensor(init_image.convert("RGB").resize(size, Image.LANCZOS))
            top = init_image.convert("RGBA").resize(size, Image.LANCZOS)
            if args.init_image_alpha and args.init_image_alpha >= 0:
                top.putalpha(args.init_image_alpha)
            cur = Image.fromarray(starting)
            cur.paste(top, (0, 0), top)
            self.init_image_rgba_list.append(cur)
        self.init_image_tensor = torch.from_numpy(rgb).to(self.device)
        return torch.from_numpy(rgb) * 2 - 1

    def _image_prompt_inputs(self, args, p) -> dict:
        """One perceptor's fixed step inputs on the device: the spot masks at
        its work canvas (1 - white on, white off) and the image prompts
        pooled to it, made once so that a captured block reads them by address."""
        out = {}
        if args.spot_prompts or args.spot_prompts_off:
            from PIL import Image

            s = p.input_resolution
            mask = IM.load_spot_mask(args.spot_file, s, args.aspect_width)
            mask = np.asarray(Image.fromarray((mask * 255).astype(np.uint8)).resize((s, s), Image.LANCZOS),
                              dtype=np.float32) / 255.0
            white = torch.from_numpy((mask >= 0.5).astype(np.float32)).to(self.device)
            out.update(spot_keep_on=1.0 - white, spot_keep_off=white)
        if self.image_prompt_images:
            out["image_prompts"] = torch.stack([C.pool_to_work(img, p.input_resolution)
                                                for img in self.image_prompt_images])
        return out

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
        """(side_y, side_x, 3) uint8: the ``--init_noise`` image (pixels,
        gradient or snow), else white, as the JAX engine makes it."""
        from pixray_tpu_torch.utils import noise

        w, h = args.size
        make = {"pixels": noise.random_noise_array, "gradient": noise.random_gradient_array,
                "snow": noise.old_random_noise_array}.get(args.init_noise)
        arr = np.full((h, w, 3), 255, dtype=np.uint8) if make is None else make(w, h, self.np_rng)
        if arr.shape[:2] != (self.side_y, self.side_x):
            # off the drawer's grid: PIL's Lanczos, as the JAX engine resizes
            # (PIL is imported only here, so an on-grid run never needs it)
            from PIL import Image

            arr = np.asarray(Image.fromarray(arr).resize((self.side_x, self.side_y), Image.LANCZOS))
        return arr

    def _loss_canvas(self) -> tuple[int, int]:
        """(h, w) of the canvas the custom losses see: the drawer's, through the filters."""
        h, w = self.side_y, self.side_x
        for filt, _weight in self.filters:
            h, w = filt.out_shape(h, w)
        return h, w

    def _skipped_losses(self, its) -> frozenset:
        """Indices of the custom losses whose gate (``host_active``) is off at every iteration of ``its``."""
        return frozenset(i for i, (loss_obj, _w) in enumerate(self.custom_losses)
                         if hasattr(loss_obj, "host_active") and not any(loss_obj.host_active(it) for it in its))

    # ------------------------------------------------------------------ draws
    def draw_step(self, planes_out=None) -> list[dict]:
        """One draws dict per batch of the next step (see ``step.pack_step``),
        drawn in the order fill, filter shifts (each in the range of the
        shape the filters before it leave), then per perceptor its cuts and
        its other banks (``cutouts.draw_step_cutouts``); after all batches,
        per batch each custom loss's draws (``draw``, for a loss that
        draws); ``planes_out`` (per batch, per perceptor: three planes)
        receives the noise planes."""
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
                                        spec.cut_size, self.args.aspect_width,
                                        self.compute_dtype or torch.float32, self.device,
                                        planes_out=None if planes_out is None else planes_out[b][i],
                                        spot=spec.spot_banks[0], spot_off=spec.spot_banks[1],
                                        image_prompts=spec.n_image_prompts,
                                        shuffle=self.step_cfg.image_prompt_shuffle)
                    for i, spec in enumerate(self.step_cfg.perceptors)
                ],
            })
        if any(self.step_cfg.loss_layouts):
            h, w = self._loss_canvas()
            for d in out:
                d["losses"] = [loss_obj.draw(self.gen, h, w) if layout else {}
                               for (loss_obj, _w), layout in zip(self.custom_losses, self.step_cfg.loss_layouts)]
        return out

    # ------------------------------------------------------------------ blocks
    def _want(self) -> int:
        return BLOCK_STEPS if self.args.steps_per_call == 0 else self.args.steps_per_call

    def _block_size(self, cur_it: int) -> int:
        """How many steps may run as one dispatch starting at ``cur_it`` (the
        JAX engine's rules): post-step host events (checkin, LR drop,
        checkpoint, display streaming) may fall only on a block's last step,
        and a pre-step event (the overlay) on none of its steps but the
        first; under animation a block ends with its frame's ``save_every``
        span (the frames swap the latent between spans); ``auto_stop``,
        ``--video`` and a drawer with ``post_step`` disable blocking;
        ``--steps_per_call 1`` forces single steps."""
        args = self.args
        if getattr(args, "steps_per_call", 0) == 1:
            return 1
        n = self._want()
        if args.make_video or args.auto_stop or hasattr(self.drawer, "post_step"):
            return 1
        n = min(n, args.iterations - cur_it)
        if self.cur_anim_index is not None:
            n = min(n, args.save_every - (cur_it % args.save_every))
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
        for it in range(cur_it + 1, cur_it + n):  # pre-step events: none inside
            if apply_overlay(args, it):
                n = it - cur_it
                break
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
        skip = self._skipped_losses(range(cur_it, cur_it + n))
        blk = self.step_blocks.get((n, skip))
        if blk is None:
            blk = self.step_blocks[(n, skip)] = StepBlock(self.step_cfg, self.optimizer, n,
                                                          bank_rows(self.step_cfg, self.args.num_cuts),
                                                          self.device, skip)
        self.step_block = blk
        rows, ints = blk.staging_inputs()
        for s in range(n):
            pack_step(self.step_cfg, self.draw_step(planes_out=blk.plane_targets(s)), cur_it + s, rows[s], ints[s],
                      anim_index=self._anim_index())
        blk.upload()
        result = blk.run(self.z, self.opt_state, self.lr_scale)
        self.steps_dispatched += n
        self.dispatched_blocks.append((cur_it, n))
        return {"start": cur_it, "n": n, "result": result, "totals": None, "valss": None}

    def _anim_index(self) -> int:
        return 0 if self.cur_anim_index is None else self.cur_anim_index

    def _consume_block(self, cur_it: int):
        """(total, values) of step ``cur_it`` from the dispatched block, or None.

        At a block's first step the next block is dispatched, when no host
        event comes between them, before this block's losses (n,) and (n,
        L) come to the host in one transfer.  Under animation the next
        block never starts a frame's span: the span starts with a checkin,
        so ``_block_size`` gives it one step."""
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
            # an overlay due at nxt rewrites the latent before step nxt, so
            # the next block waits for it (_block_size(nxt) looks past nxt)
            if (self._next_block is None and not self._has_host_event(nxt - 1)
                    and not apply_overlay(self.args, nxt)
                    and self._block_size(nxt) == want and want > 1):
                self._next_block = self._dispatch_block(nxt, want)
            b["totals"], b["valss"] = b["result"].host()
        total, values = b["totals"][idx], b["valss"][idx]
        if idx == b["n"] - 1:
            self._block, self._next_block = self._next_block, None
        return total, values

    # ------------------------------------------------------------------ train/run
    def train(self, cur_it: int, draws=None, renoise=None) -> bool:
        """One optimizer step + host scheduling; False when the run should end.

        The step comes from a dispatched block where one covers ``cur_it``
        (a full-size block is dispatched here when ``_block_size`` allows
        one), else it runs eagerly.  ``draws`` (one dict per batch) replaces
        this step's random draws and makes it one eager step.  A drawer with
        ``post_step`` (vdiff) then re-noises the latent with ``renoise``, or
        a normal draw from the device generator, and the optimizer starts
        afresh, as in the JAX engine (after the checkin and the video,
        before the LR drop)."""
        args = self.args
        rebuild_opts_when_done = False

        if cur_it < args.iterations:
            if cur_it == 0 and self.init_image_rgba_list and self.cur_anim_index is not None:
                n = len(self.init_image_rgba_list)
                self.reapply_from_image(self.init_image_rgba_list[self.cur_anim_index % n])
            if apply_overlay(args, cur_it):
                if self.cur_anim_index is not None and self.overlay_image_rgba_list:
                    n = len(self.overlay_image_rgba_list)
                    self.overlay_image_rgba = self.overlay_image_rgba_list[self.cur_anim_index % n]
                self.re_average_z()
            buffered = None
            img = None
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
                inputs = draws_to_inputs(self.step_cfg, batch_draws, cur_it, self.device,
                                         anim_index=self._anim_index(), skip=self._skipped_losses([cur_it]))
                total, values, img = train_step(self.step_cfg, self.optimizer, self.z, self.opt_state,
                                                self.lr_scale, inputs)
                self.steps_dispatched += 1
            self.last_loss_values = values

            if self.cur_anim_index is None or self.cur_anim_index == 0:
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

            if args.make_video and self.writer:  # single steps: every step is eager
                video_folder = os.path.join(args.outdir, "video")
                os.makedirs(video_folder, exist_ok=True)
                OUT.save_png(img[..., :3].float().cpu().numpy(), os.path.join(video_folder, f"frame_{cur_it:04d}.png"))

        post_step = getattr(self.drawer, "post_step", None)
        if post_step is not None:
            # the vdiff drawer: re-noise the latent to the next schedule entry
            # (in place) and start a fresh optimizer at the drawer's new rate
            if renoise is None:
                renoise = torch.randn(leaves(self.z)[0].shape, generator=self.gen_device, device=self.device)
            new_z = post_step(self.z, cur_it, renoise)
            if new_z is not None:
                _copy_into(self.z, new_z)
                self._build_optimizer()

        if cur_it == args.iterations:
            self.checkin(cur_it, self.last_loss_values)
            return False
        if rebuild_opts_when_done:
            if not self.tracker.register_drop(cur_it):
                return False
            # in place: a captured block reads the state and the scale where they are
            self.optimizer.reset(self.opt_state)
            self.lr_scale.fill_(1.0 / self.tracker.drop_divisor)
        ck = args.checkpoint_every
        if ck and cur_it and cur_it % ck == 0 and self.writer:
            from pixray_tpu_torch.engine.checkpoint import save_session

            # after the step and its LR drop: the file resumes at the next step
            save_session(os.path.join(args.outdir, "session.ckpt"), self, iteration=cur_it + 1)
        return True

    def synth_image(self):
        """The canvas as a PIL image (the drawer's output, without the filters)."""
        return IM.from_tensor(self.synth_array())

    @torch.no_grad()
    def re_average_z(self):
        """The overlay: render, paste the overlay image over it, and re-encode
        the latent into its own tensors (a captured block reads them where
        they are); the optimizer state stays.  A drawer without an encoder
        raises NotImplementedError."""
        from PIL import Image

        cur = self.synth_image().convert("RGB")
        if self.overlay_image_rgba is not None:
            cur.paste(self.overlay_image_rgba, (0, 0), mask=self.overlay_image_rgba)
        cur = cur.resize((self.side_x, self.side_y), Image.LANCZOS)
        _copy_into(self.z, self.drawer.params_from_image(torch.from_numpy(IM.to_tensor(cur)).to(self.device) * 2 - 1))

    @torch.no_grad()
    def reapply_from_image(self, pil_image):
        """Encode an image into the latent's own tensors; a drawer without an
        encoder keeps the latent, as the JAX engine does."""
        from PIL import Image

        pil_image = pil_image.convert("RGB").resize((self.side_x, self.side_y), Image.LANCZOS)
        try:
            new = self.drawer.params_from_image(torch.from_numpy(IM.to_tensor(pil_image)).to(self.device) * 2 - 1)
        except NotImplementedError:
            return
        _copy_into(self.z, new)

    @torch.no_grad()
    def synth_array(self, iteration=None) -> np.ndarray:
        """The drawer's canvas at ``iteration`` (default: the engine's)."""
        it = self.cur_iteration if iteration is None else iteration
        arr = self.drawer.synth(self.drawer_params, self.z, it).float().cpu().numpy()
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
        if self.cur_anim_index is not None:
            writestr = f"anim: {self.cur_anim_index}/{len(self.anim_output_files)} {writestr}"
            outfile = self.anim_output_files[self.cur_anim_index]
        else:
            stale = it - self.tracker.best_iter
            writestr = f"{writestr} (-{stale}=>{self.tracker.best_loss:2.4g})"
            outfile = get_file_path(args.outdir, args.output, ".png")
        if self.writer:
            arr = self.synth_array(it)
            OUT.save_png(arr, outfile, OUT.png_text(args.given_args, self.seed_used))
            if args.save_intermediates:
                step_path = os.path.join(args.outdir, "steps")
                os.makedirs(step_path, exist_ok=True)
                OUT.save_png(arr, get_file_path(step_path, f"frame_{it:04d}", ".png"))
            if self.cur_anim_index is not None and self.cur_anim_index == len(self.anim_output_files) - 1:
                OUT.make_gif(args.animation_dir)
        print(writestr)

    def run(self, return_display: bool = False) -> bool:
        """Train until ``iterations`` (the final checkin included), or until
        interrupted; then the videos and the SVG.  True when the run is
        complete; with ``return_display``, False every ``display_every``
        steps, to be called again for the rest (the caller streams partial
        results).  ``--animation_dir`` runs the animation ring instead."""
        from pixray_tpu_torch.engine.profiling import device_trace

        args = self.args
        # a block must end at a display step when the caller streams them
        self._display_streaming = return_display
        if args.animation_dir is not None:
            return self._run_animation()
        profile_dir = args.profile_dir if self.cur_iteration == 0 else None
        try:
            with device_trace(profile_dir, self.device, "(start of run)"):
                keep_going = True
                while keep_going:
                    keep_going = self.train(self.cur_iteration)
                    if self.cur_iteration == args.iterations:
                        break
                    self.cur_iteration += 1
                    if keep_going and return_display and self.cur_iteration % args.display_every == 0:
                        return False
        except KeyboardInterrupt:
            pass
        if not self.writer:
            return True
        if args.make_video:
            OUT.do_video(args, self.cur_iteration)
        if args.save_intermediates:
            OUT.step_to_video(args)
        if args.save_svg:
            self.save_svg()
        return True

    def save_svg(self):
        """Vector export for drawers that have one (pixel, clipdraw, line_sketch)."""
        to_svg = getattr(self.drawer, "to_svg", None)
        if to_svg is None:
            print(f"drawer {self.args.drawer} has no SVG export")
            return None
        outfile = get_file_path(self.args.outdir, self.args.output, ".svg")
        with open(outfile, "w") as f:
            f.write(to_svg(self.z))
        print(f"saved {outfile}")
        return outfile

    # ------------------------------------------------------------------ animation
    def _anim_filelist(self) -> list[str]:
        """The animation's frame files: the first of the overlay, target,
        init and prompt image lists, or a later one that is longer."""
        args = self.args
        filelist: list[str] = []
        source = None

        def consider(cur_source, cur_list):
            nonlocal source, filelist
            if source is None:
                print(f"==> setting animation filelist to {cur_source} ({len(cur_list)} files)")
                source, filelist = cur_source, cur_list
            elif len(cur_list) > len(filelist):
                print(f"==> anim filelist {cur_source} has {len(cur_list)} files - switching")
                source, filelist = cur_source, cur_list
            else:
                print(f"==> anim filelist {cur_source} not larger - sticking with {source}")

        if args.overlay_image is not None:
            consider("overlay_images", real_glob(args.overlay_image))
        if args.target_images:
            files = []
            for t in args.target_images:
                f1, _w, _s = parse_prompt(t)
                files.extend(real_glob(f1))
            consider("target_images", files)
        if args.init_image is not None:
            consider("init_images", real_glob(args.init_image))
        if args.image_prompts:
            consider("image_prompts", list(args.image_prompts))
        return filelist

    def _run_animation(self) -> bool:
        """Rounds of ``save_every`` steps per frame, each frame from its own
        latent, with the previous frame blended in between rounds."""
        args = self.args
        os.makedirs(args.animation_dir, exist_ok=True)
        filelist = self._anim_filelist()
        num_frames = len(filelist)
        self.anim_output_files = [os.path.join(args.animation_dir, os.path.basename(f)) for f in filelist]
        self.anim_cur_zs = [tree_map(torch.clone, self.z) for _ in range(num_frames)]

        step_iteration = 0
        while True:
            cur_images = []
            for i in range(num_frames):
                self.cur_anim_index = i
                self.cur_iteration = step_iteration
                _copy_into(self.z, self.anim_cur_zs[i])
                for _ in range(args.save_every):
                    self.train(self.cur_iteration)
                    self.cur_iteration += 1
                _copy_into(self.anim_cur_zs[i], self.z)
                cur_images.append(self.synth_image())
            step_iteration += args.save_every
            if step_iteration >= args.iterations:
                break
            for i in range(num_frames):  # blend each frame with the one before it
                prev_i = (i + num_frames - 1) % num_frames
                base = cur_images[i].copy().convert("RGB")
                prev = cur_images[prev_i].copy().convert("RGBA")
                prev.putalpha(args.animation_alpha)
                base.paste(prev, (0, 0), prev)
                self.reapply_from_image(base)
                _copy_into(self.anim_cur_zs[i], self.z)
        return True


@torch.no_grad()
def _copy_into(dst, src):
    """Copy the tree ``src`` into the tensors of ``dst`` (the latent's: a
    captured block reads them where they are)."""
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)


def _uint8_to_unit(arr: np.ndarray) -> torch.Tensor:
    """uint8 (H, W, 3) → float32 [0, 1] tensor (the JAX package's ``to_tensor``)."""
    return torch.from_numpy(np.asarray(arr, dtype=np.float32) / 255.0)
