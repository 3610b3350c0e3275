"""VQGAN drawer: the latent is a continuous code grid, synth = quantize +
decode (port of ``pixray_tpu/drawers/vqgan.py``).

The latent keeps the JAX shape (toks_y, toks_x, embed_dim), so its ravel
order and the init-weight terms match; it is permuted to NCHW inside
``synth``.  After each step it is clamped to the codebook's per-dim
min/max.  The canvas snaps to the decoder's grid, 2 ** (levels - 1) px.

Weights: a taming ``.ckpt`` at ``--vqgan_checkpoint`` (default
``models/vqgan_<model>.ckpt``), a state dict handed to ``load_model``, or,
with neither, seeded random weights and a loud warning.  The URL table is
provenance only: the port never downloads.  Loaded models are cached per
(checkpoint, device, dtype).
"""

from __future__ import annotations

import os

import torch

from pixray_tpu_torch.models.vqgan import VQGAN, VQGAN_CONFIGS, init_random_, load_taming_state_dict
from pixray_tpu_torch.ops.grad import clamp_with_grad

# where the reference fetched each checkpoint (provenance only)
VQGAN_CHECKPOINT_URLS = {
    "imagenet_f16_1024": "http://mirror.io.community/blob/vqgan/vqgan_imagenet_f16_1024.ckpt",
    "imagenet_f16_16384": "https://heibox.uni-heidelberg.de/d/a7530b09fed84f80a887/files/?p=%2Fckpts%2Flast.ckpt&dl=1",
    "imagenet_f16_16384m": "http://mirror.io.community/blob/vqgan/vqgan_imagenet_f16_16384.ckpt",
    "openimages_f16_8192": "https://heibox.uni-heidelberg.de/d/2e5662443a6b4307b470/files/?p=%2Fckpts%2Flast.ckpt&dl=1",
    "coco": "https://dl.nmkd.de/ai/clip/coco/coco.ckpt",
    "faceshq": "https://app.koofr.net/content/links/a04deec9-0c59-4673-8b37-3d696fe63a5d/files/get/last.ckpt?path=%2F2020-11-13T21-41-45_faceshq_transformer%2Fcheckpoints%2Flast.ckpt",
    "wikiart_1024": "https://github.com/pixray/pixray/releases/download/v1.7.1/vqgan_wikiart_1024.ckpt",
    "wikiart_1024m": "http://mirror.io.community/blob/vqgan/wikiart.ckpt",
    "wikiart_16384": "https://github.com/pixray/pixray/releases/download/v1.7.1/vqgan_wikiart_16384.ckpt",
    "wikiart_16384m": "http://eaidata.bmk.sh/data/Wikiart_16384/wikiart_f16_16384_8145600.ckpt",
    "wikiart_16384m2": "http://mirror.io.community/blob/vqgan/wikiart_16384.ckpt",
    "sflckr": "https://heibox.uni-heidelberg.de/d/73487ab6e5314cb5adba/files/?p=%2Fcheckpoints%2Flast.ckpt&dl=1",
}
VQGAN_CHECKPOINT_TABLE = {name: f"models/vqgan_{name}.ckpt" for name in VQGAN_CONFIGS}

RANDOM_INIT_SEED = 0

_global_model_cache: dict = {}


def _build_model(name: str, path: str, state_dict=None) -> VQGAN:
    config = VQGAN_CONFIGS.get(name)
    if config is None:
        raise ValueError(f"unknown VQGAN model {name}")
    model = VQGAN(config)
    if state_dict is None and os.path.exists(path):
        ckpt = torch.load(path, map_location="cpu")
        state_dict = ckpt.get("state_dict", ckpt)
        print(f"Loaded VQGAN {name} from {path}")
    if state_dict is not None:
        return load_taming_state_dict(model, state_dict)
    print(f"WARNING: VQGAN checkpoint {path} not found — random weights "
          "(place taming .ckpt files under models/; nothing is downloaded)")
    return init_random_(model, torch.Generator().manual_seed(RANDOM_INIT_SEED))


class VqganDrawer:
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--vqgan_model", type=str, help="VQGAN model", default="imagenet_f16_16384", dest="vqgan_model")
        parser.add_argument("--vqgan_config", type=str, help="VQGAN config", default=None, dest="vqgan_config")
        parser.add_argument("--vqgan_checkpoint", type=str, help="VQGAN checkpoint", default=None, dest="vqgan_checkpoint")
        return parser

    def __init__(self, settings):
        self.canvas_width, self.canvas_height = settings.size
        self.vqgan_model = settings.vqgan_model
        self.checkpoint_path = settings.vqgan_checkpoint or VQGAN_CHECKPOINT_TABLE.get(
            self.vqgan_model, f"models/vqgan_{self.vqgan_model}.ckpt"
        )
        self.model_params = {}  # the frozen model lives on the drawer

    def load_model(self, settings, device, dtype=torch.float32, state_dict=None):
        """Weights from ``state_dict`` (taming names), else the checkpoint
        file, else random; the model is frozen, on ``device``, computing in
        ``dtype`` (see ``models/vqgan.py``)."""
        device = torch.device(device)
        key = (self.checkpoint_path, str(device), dtype)
        model = None if state_dict is not None else _global_model_cache.get(key)
        if model is None:
            model = _build_model(self.vqgan_model, self.checkpoint_path, state_dict)
            model = model.to(device).to_compute_dtype(dtype).eval().requires_grad_(False)
            if state_dict is None:
                _global_model_cache[key] = model
        else:
            print("reusing cached copy of model ", self.checkpoint_path)
        self.model = model
        self.config = model.config
        self.device = device
        codebook = model.quantize.codebook.detach()
        self.z_min = codebook.amin(dim=0)
        self.z_max = codebook.amax(dim=0)

    def snap_canvas(self, size):
        f = 2 ** (self.config.num_resolutions - 1)
        self.canvas_width, self.canvas_height = size[0] // f * f, size[1] // f * f
        return self.canvas_width, self.canvas_height

    # ------------------------------------------------------------------ latents
    @torch.no_grad()
    def _encode(self, image_tensor):
        """[-1, 1] (H, W, 3) image → quantized latent grid (h, w, embed_dim)."""
        x = torch.as_tensor(image_tensor, dtype=torch.float32).to(self.device)
        return self.model.encode(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0).contiguous()

    def init_params(self, gen, init_tensor=None, indices=None):
        """The encoded ``init_tensor``, or one random code per token
        (``indices`` may inject the draw)."""
        if init_tensor is not None:
            return self._encode(init_tensor)
        f = 2 ** (self.config.num_resolutions - 1)
        toks_y, toks_x = self.canvas_height // f, self.canvas_width // f
        codebook = self.model.quantize.codebook.detach()
        if indices is None:
            indices = torch.randint(0, codebook.shape[0], (toks_y * toks_x,), generator=gen)
        indices = torch.as_tensor(indices, dtype=torch.long, device=codebook.device)
        return codebook[indices].reshape(toks_y, toks_x, -1).clone()

    def params_from_image(self, image_tensor):
        return self._encode(image_tensor)

    def clip_params(self, z):
        return torch.clamp(z, self.z_min, self.z_max)

    # ------------------------------------------------------------------- render
    def synth(self, model_params, z):
        """(toks_y, toks_x, C) latent → (H, W, 3) canvas in [0, 1]."""
        decoded = self.model.decode_from_continuous(z.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
        return clamp_with_grad((decoded + 1.0) / 2.0, 0.0, 1.0)
