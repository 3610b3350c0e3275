"""v-diffusion drawer: each engine iteration is one CLIP-guided sampler
step (port of ``pixray_tpu/drawers/vdiff.py``).

The latent is the diffusion state x in the JAX layout (1, H, W, 3), on the
canvas rounded up to 128 px; ``synth(x, i)`` runs the v-objective model at
schedule entry ``i`` and shows CLIP the denoised ``pred``, centre-cropped
back to the canvas.  After every optimizer step from step 1 on,
``post_step`` re-noises x to the next entry (its normal draw an argument)
and sets the learning rate of the fresh Adam the engine then builds,
min(sigma_i / alpha_i · 0.001, 0.01), from a host copy of the schedule.
The cc12m models take the weighted prompt embedding of their perceptor
(``set_clip_embed``), kept as a device tensor in the drawer's parameters.

Weights: a state dict handed to ``load_model`` (upstream names for every
published model, ``models/vdiff.py`` names for ``tiny_test``), else
``<name>.pth`` found in ``$PIXRAY_TPU_MODELS``, ``models/`` or
``~/.cache/pixray_tpu`` (nothing is downloaded), else seeded random
weights drawn on the device, with the JAX package's warning.
"""

from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import torch

from pixray_tpu_torch.models.vdiff import (
    VDIFF_CONFIGS,
    VDiffUNet,
    get_log_schedule,
    get_spliced_ddpm_cosine_schedule,
    linspace,
    sample_noise,
    sample_setup,
    sample_step,
)
from pixray_tpu_torch.models.vdiff_upstream import UPSTREAM_SPECS, VDiffUpstream, check_state_dict, init_random_
from pixray_tpu_torch.ops.grad import clamp_with_grad
from pixray_tpu_torch.utils import map_number
from pixray_tpu_torch.utils.files import find_model_file

ROUNDUP_SIZE = 128


def roundup(x, n):
    return int(math.ceil(x / float(n))) * n


def _seed(name: str) -> int:
    """The JAX package's per-model seed (sha256 of the name)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big") % (2**31)


def build_vdiff_model(name: str, device, state_dict=None):
    """(model (frozen, float32, on ``device``), config or spec, seconds it
    took to place the weights, where the weights came from)."""
    device = torch.device(device)
    if name in UPSTREAM_SPECS:
        spec = UPSTREAM_SPECS[name]
        with torch.device("meta"):
            model = VDiffUpstream(spec)
    elif name in VDIFF_CONFIGS:
        spec = VDIFF_CONFIGS[name]
        with torch.device("meta"):
            model = VDiffUNet(spec)
    else:
        raise ValueError(f"unknown v-diffusion model {name}")
    source = "state dict"
    if state_dict is None:
        path = find_model_file([f"{name}.pth"])
        if path is not None:
            ckpt = torch.load(path, map_location="cpu")
            state_dict = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
            source = path
    t0 = time.perf_counter()
    model = model.to_empty(device=device)
    if state_dict is not None:
        if name in UPSTREAM_SPECS:
            check_state_dict(state_dict, spec)
        model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32)) if isinstance(v, np.ndarray) else v.float()
                               for k, v in state_dict.items()}, strict=True)
    else:
        init_random_(model, torch.Generator(device=device).manual_seed(_seed(name)))
        source = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return model, spec, time.perf_counter() - t0, source


class VdiffDrawer:
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--vdiff_model", type=str, help="VDIFF model from [yfcc_2, yfcc_1, cc12m_1, cc12m_1_cfg, ...]", default="yfcc_2", dest="vdiff_model")
        parser.add_argument("--vdiff_schedule", type=str, help="VDIFF schedule [default, log]", default="default", dest="vdiff_schedule")
        parser.add_argument("--vdiff_skip", type=float, help="skip a percentage of the decay schedule (0-100)", default=0, dest="vdiff_skip")
        return parser

    def __init__(self, settings):
        self.canvas_width, self.canvas_height = settings.size
        self.vdiff_model = settings.vdiff_model
        self.gen_width = roundup(self.canvas_width, ROUNDUP_SIZE)
        self.gen_height = roundup(self.canvas_height, ROUNDUP_SIZE)
        self.iterations = settings.iterations
        self.schedule = settings.vdiff_schedule
        self.eta = 1.0
        self.vdiff_skip = settings.vdiff_skip
        self.learning_rate = 0.01  # replaced per step by post_step
        self.model_params = {}  # the model lives on the drawer; "clip_embed" once set

    def load_model(self, settings, device, dtype=torch.float32, state_dict=None):
        """The model on ``device`` computing in ``dtype`` (see
        ``models/vdiff_upstream.py``), and the schedule on the device with a
        host copy."""
        model, self.config, self.init_seconds, source = build_vdiff_model(self.vdiff_model, device, state_dict)
        if source is None:
            print(f"WARNING: v-diffusion weights for {self.vdiff_model} not found — random init "
                  f"({self.init_seconds:.2f} s on {torch.device(device)}; nothing is downloaded)")
        else:
            print(f"loaded v-diffusion weights for {self.vdiff_model} from {source}")
        self.model = model.to_compute_dtype(dtype).eval().requires_grad_(False)
        self.clip_model = self.config.clip_model
        if self.clip_model is not None:
            assert self.clip_model in settings.clip_models, (
                f"try adding {self.clip_model} to clip_models settings - vdiff model "
                f"{self.vdiff_model} needs it but it is not active"
            )
        # t from (1 - skip%) down to 0, float32 as in JAX
        top_val = map_number(self.vdiff_skip, 0, 100, 1, 0)
        t = linspace(top_val, 0.0, self.iterations + 2)[:-1]
        steps = get_log_schedule(t) if self.schedule == "log" else get_spliced_ddpm_cosine_schedule(t)
        host = sample_setup(steps, self.eta)
        self.alphas_host, self.sigmas_host = host.alphas.numpy(), host.sigmas.numpy()
        self.sample_state = sample_setup(steps.to(device), self.eta)

    def snap_canvas(self, size):
        self.canvas_width, self.canvas_height = size
        return self.canvas_width, self.canvas_height

    def set_clip_embed(self, clip_embed):
        """The weighted prompt embedding (cc12m conditioning), on the model's
        device.  Its width must be the model's (the JAX package's
        ``tiny_up_mod`` takes 12, its perceptor TinyTest gives 32)."""
        embed = torch.as_tensor(np.asarray(clip_embed, np.float32))
        if embed.shape[-1] != self.config.clip_embed_dim:
            raise ValueError(f"vdiff model {self.vdiff_model} takes a {self.config.clip_embed_dim}-wide clip "
                             f"embedding, {self.clip_model} gives {embed.shape[-1]}")
        self.model_params["clip_embed"] = embed.to(self.sample_state.steps.device)

    # ------------------------------------------------------------------ latents
    def init_params(self, gen, init_tensor=None, noise=None):
        """(1, H, W, 3) normal draw (``noise`` may inject it), blended with
        ``init_tensor`` (centred on the generated canvas) at alphas[0] /
        sigmas[0]."""
        x = torch.randn((1, self.gen_height, self.gen_width, 3), generator=gen) if noise is None else noise
        x = torch.as_tensor(x, dtype=torch.float32)
        if init_tensor is not None:
            new_x = torch.zeros_like(x)
            my = (self.gen_height - self.canvas_height) // 2
            mx = (self.gen_width - self.canvas_width) // 2
            new_x[0, my:my + self.canvas_height, mx:mx + self.canvas_width] = torch.as_tensor(init_tensor).to(x)
            x = new_x * self.sample_state.alphas[0].cpu() + x * self.sample_state.sigmas[0].cpu()
        return x

    def params_from_image(self, image_tensor):
        # the reference cannot re-encode into diffusion state either
        raise NotImplementedError("vdiff cannot re-encode images into x")

    def clip_params(self, z):
        return z

    # ------------------------------------------------------------------- render
    def _model_fn(self, model_params):
        clip_embed = model_params.get("clip_embed") if self.clip_model is not None else None

        def fn(x, t):
            v = self.model(x.permute(0, 3, 1, 2), t, clip_embed)
            return v.permute(0, 2, 3, 1)

        return fn

    def synth(self, model_params, z, iteration=None):
        """(1, H, W, 3) latent at schedule entry ``iteration`` (an int or a ()
        device tensor) → the (h, w, 3) canvas in [0, 1]."""
        pred, _v = sample_step(self.sample_state, z, iteration, self._model_fn(model_params))
        pixels = clamp_with_grad((pred + 1.0) / 2.0, 0.0, 1.0)[0]
        my = (self.gen_height - self.canvas_height) // 2
        mx = (self.gen_width - self.canvas_width) // 2
        return pixels[my:my + self.canvas_height, mx:mx + self.canvas_width]

    # ------------------------------------------------------- per-step re-noising
    @torch.no_grad()
    def post_step(self, z, cur_it, noise):
        """After step ``cur_it``: the latent re-noised to entry cur_it + 1
        with the N(0, 1) draw ``noise``, and the learning rate of the fresh
        optimizer set; None (nothing changes) before step 1."""
        if cur_it < 1:
            return None
        i = min(cur_it, len(self.alphas_host) - 1)
        lr = float(self.sigmas_host[i] / np.maximum(self.alphas_host[i], np.float32(1e-8)))
        self.learning_rate = min(lr * 0.001, 0.01)
        pred, v = sample_step(self.sample_state, z, cur_it, self._model_fn(self.model_params))
        return sample_noise(self.sample_state, z, cur_it, pred, v, noise)
