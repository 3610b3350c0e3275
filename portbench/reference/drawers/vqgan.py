"""Plain VQGAN drawer: a continuous (tokens_y, tokens_x, embed_dim) latent,
quantized to its nearest codes (straight-through) and decoded; the image
clamped to [0, 1] with a gradient that only drops components pushing
further out; the latent clamped per dimension to the codebook's range
after each step.  Imports nothing of the program."""

from __future__ import annotations

import torch

from portbench.reference.vqgan import VQGAN


class _Clamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (g * (x - x.clamp(0.0, 1.0)) >= 0).to(g.dtype)


class Drawer:
    def __init__(self, settings: dict, weights, device):
        dims = settings["vqgan_dims"]
        f = 2 ** (len(dims["ch_mult"]) - 1)
        self.width, self.height = settings["size"][0] // f * f, settings["size"][1] // f * f
        self.toks = (self.height // f, self.width // f)
        self.lr = settings["learning_rate"]
        if settings.get("init_noise") is not None:
            raise NotImplementedError(
                f"the VQGAN drawer's reference starts from random codes, not {settings['init_noise']!r}")
        self.model = VQGAN(dims).to(device)
        self.model.load_state_dict(weights)
        self.model.requires_grad_(False)
        cb = self.model.quantize.embedding.weight
        self.lo, self.hi = cb.amin(0), cb.amax(0)

    def init(self, gen, seed: int):
        """One random code per token."""
        cb = self.model.quantize.embedding.weight
        idx = torch.randint(0, cb.shape[0], (self.toks[0] * self.toks[1],), generator=gen)
        return cb[idx.to(cb.device)].reshape(*self.toks, -1).clone()

    def synth(self, z):
        out = self.model.decode_from_continuous(z.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
        return _Clamp.apply((out + 1.0) / 2.0)

    def clip(self, z):
        return torch.clamp(z, self.lo, self.hi)


def synth_flops(settings: dict) -> float:
    from portbench.harness.counts import decoder_step_flops

    dims = settings["vqgan_dims"]
    f = 2 ** (len(dims["ch_mult"]) - 1)
    return decoder_step_flops(dims, settings["size"][1] // f * f, settings["size"][0] // f * f)
