"""Super-resolution drawer: a quarter-size latent image optimized through
Real-ESRGAN (port of ``pixray_tpu/drawers/super_resolution.py``).

The latent is an (H/4, W/4, 3) image in [0, 1] (uniform at init, the draw
may be passed in; an init image is resized to it with ``jax.image.resize``'s
antialiased bilinear, ``ops/pool.linear_resize``); ``synth`` upscales it 4x
through the frozen RRDBNet, crops to the canvas and clamps with the
gradient kept inside [0, 1].  The drawer has no ``post_step``, so its steps
run blocked like any other drawer's.

Weights: a basicsr state dict handed to ``load_model``, else
``super_resolution_<model>.ckpt`` (the JAX package's file under
``models/``) or ``<model>.pth`` found in ``$PIXRAY_TPU_MODELS``,
``models/`` or ``~/.cache/pixray_tpu`` (nothing is downloaded), else
seeded random weights.  No process-wide model cache.
"""

from __future__ import annotations

import torch

from pixray_tpu_torch.models.esrgan import RRDBNet, basicsr_state_dict, init_random_, rrdbnet_for
from pixray_tpu_torch.ops.grad import clamp_with_grad
from pixray_tpu_torch.ops.pool import linear_resize
from pixray_tpu_torch.utils.files import find_model_file

# where the reference fetched the checkpoint (provenance only)
SUPERRESOLUTION_CHECKPOINT_TABLE = {
    "RealESRGAN_x4plus": "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.1.0/RealESRGAN_x4plus.pth",
}

RANDOM_INIT_SEED = 0


class SuperResolutionDrawer:
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--super_resolution_model", type=str, help="Super resolution model", default="RealESRGAN_x4plus", dest="super_resolution_model")
        return parser

    def __init__(self, settings):
        self.canvas_width, self.canvas_height = settings.size
        self.super_resolution_model = settings.super_resolution_model
        self.model_params = {}  # the frozen model lives on the drawer

    def load_model(self, settings, device, dtype=torch.float32, state_dict=None):
        """The RRDBNet on ``device`` computing in ``dtype``."""
        name = self.super_resolution_model
        if state_dict is None:
            path = find_model_file([f"super_resolution_{name}.ckpt", f"{name}.pth"])
            if path is not None:
                state_dict = basicsr_state_dict(torch.load(path, map_location="cpu"))
                print(f"Loaded RealESRGAN from {path}")
        if state_dict is not None:
            state_dict = {k: torch.as_tensor(v).float() for k, v in basicsr_state_dict(state_dict).items()}
            model = rrdbnet_for(state_dict)
            model.load_state_dict(state_dict)
            model = model.to(device)
        else:
            print(f"WARNING: super_resolution_{name}.ckpt not found — random RRDBNet weights "
                  "(place RealESRGAN_x4plus.pth under models/; nothing is downloaded)")
            model = init_random_(RRDBNet().to(device), torch.Generator(device=device).manual_seed(RANDOM_INIT_SEED))
        self.model = model.to_compute_dtype(dtype).eval().requires_grad_(False)

    def snap_canvas(self, size):
        self.canvas_width, self.canvas_height = size
        return self.canvas_width, self.canvas_height

    # ------------------------------------------------------------------ latents
    def init_params(self, gen, init_tensor=None, rgb=None):
        """(H/4, W/4, 3) uniform in [0, 1) (``rgb`` may inject the draw), or
        ``init_tensor`` resized to it."""
        if init_tensor is not None:
            return self.params_from_image(init_tensor)
        shape = (self.canvas_height // 4, self.canvas_width // 4, 3)
        return torch.rand(shape, generator=gen) if rgb is None else torch.as_tensor(rgb, dtype=torch.float32)

    def params_from_image(self, image_tensor):
        img01 = (torch.as_tensor(image_tensor, dtype=torch.float32) + 1.0) / 2.0
        return linear_resize(img01, self.canvas_height // 4, self.canvas_width // 4)

    def clip_params(self, z):
        return torch.clamp(z, 0.0, 1.0)

    # ------------------------------------------------------------------- render
    def synth(self, model_params, z, iteration=None):
        """(h, w, 3) latent → the (H, W, 3) canvas in [0, 1]."""
        out = self.model(z.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
        return clamp_with_grad(out[: self.canvas_height, : self.canvas_width], 0.0, 1.0)
