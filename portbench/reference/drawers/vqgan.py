"""Plain VQGAN drawer: a continuous (tokens_y, tokens_x, embed_dim) latent,
quantized to its nearest codes (straight-through) and decoded; the image
clamped to [0, 1] with a gradient that only drops components pushing
further out; the latent clamped per dimension to the codebook's range
after each step.  An init image is encoded (``encode``) and quantized
(``quantize``).  The drawer's own model is the VQGAN (``model``, weights
under the key ``"vqgan"``, initialised by ``init_rule``).  Imports nothing
of the program."""

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
        self.init_noise = settings.get("init_noise")
        self.model = VQGAN(dims).to(device)
        self.model.load_state_dict(weights)
        self.model.requires_grad_(False)
        cb = self.model.quantize.embedding.weight
        self.lo, self.hi = cb.amin(0), cb.amax(0)

    def init(self, gen, seed: int):
        """One random code per token."""
        if self.init_noise is not None:
            raise NotImplementedError(
                f"the VQGAN drawer's reference starts from random codes, not {self.init_noise!r}")
        cb = self.model.quantize.embedding.weight
        idx = torch.randint(0, cb.shape[0], (self.toks[0] * self.toks[1],), generator=gen)
        return cb[idx.to(cb.device)].reshape(*self.toks, -1).clone()

    def encode(self, image):
        """(H, W, 3) image in [-1, 1] → (1, embed_dim, tokens_y, tokens_x): the
        encoder's output before quantization (taming's ``quant_conv(encoder(x))``)."""
        m = self.model
        with torch.no_grad():
            return m.quant_conv(m.encoder(image.to(m.quant_conv.weight.device).permute(2, 0, 1)[None].float()))

    def quantize(self, pre):
        """``encode``'s output → the latent of its nearest codes, (tokens_y, tokens_x, embed_dim), as
        the straight-through quantizer gives it (``pre + (code - pre)``, each code to rounding)."""
        with torch.no_grad():
            return self.model.quantize(pre)[0].permute(1, 2, 0).contiguous()

    def codes(self, latent):
        """(tokens_y, tokens_x, embed_dim) latent → (tokens_y * tokens_x,) its nearest codes' indices."""
        with torch.no_grad():
            return self.model.quantize.nearest(latent.reshape(-1, latent.shape[-1]).float())

    def synth(self, z):
        out = self.model.decode_from_continuous(z.permute(2, 0, 1)[None])[0].permute(1, 2, 0)
        return _Clamp.apply((out + 1.0) / 2.0)

    def clip(self, z):
        return torch.clamp(z, self.lo, self.hi)


def model(settings: dict):
    """(the weights' key, the drawer's own model, its sizes)."""
    return "vqgan", VQGAN(settings["vqgan_dims"]), settings["vqgan_dims"]


def init_rule(name: str, shape, d: dict):
    """The initialiser of one VQGAN tensor: lecun-normal convolutions, unit
    scales and zero shifts in every norm, zero biases, and a unit-normal
    codebook (not the program's uniform on [0, 2 / n_embed): that box is
    1.2e-4 wide per dimension at 16384 codes, and every Adam step at the
    drawer's rate of 0.2 throws the latent into one of its corners by its
    gradient's signs alone, so that the step's result no longer depends on
    the towers, the bank or the batch)."""
    if name == "quantize.embedding.weight":
        return ("normal", 1.0)
    if ".norm" in name:  # norm1, norm2, an attention block's norm, norm_out
        return ("ones",) if name.endswith("weight") else ("zeros",)
    if name.endswith("bias"):
        return ("zeros",)
    return ("normal", (shape[1] * shape[2] * shape[3]) ** -0.5)


def synth_flops(settings: dict) -> float:
    from portbench.harness.counts import decoder_step_flops

    dims = settings["vqgan_dims"]
    f = 2 ** (len(dims["ch_mult"]) - 1)
    return decoder_step_flops(dims, settings["size"][1] // f * f, settings["size"][0] // f * f)
