"""v-diffusion: schedules, the stepwise v-objective sampler and the compact
UNet (port of ``pixray_tpu/models/vdiff.py``).

    alpha_t, sigma_t = cos(t·π/2), sin(t·π/2)
    v    = model(x, t)
    pred = x·alpha_t − v·sigma_t            (the denoised estimate CLIP sees)
    eps  = x·sigma_t + v·alpha_t
    ddim_sigma = eta·sqrt(sigma²_{i+1}/sigma²_i)·sqrt(1 − alpha²_i/alpha²_{i+1})
    x_{i+1} = pred·alpha_{i+1} + eps·sqrt(sigma²_{i+1} − ddim_sigma²) + N(0,1)·ddim_sigma

The schedules and the sampler run in float32, in the JAX package's op
order, with its clamps.  A schedule entry is read at a Python int or at a
() integer tensor on the device (a captured step may not read a device
value on the host), and the index is clamped to the table as JAX clamps
an out-of-range gather: the engine's last ``post_step`` reads
``alphas[iterations + 1]``, one past the end.  ``sample_noise`` takes its
normal draw as an argument (the JAX drawer draws it from
``PRNGKey(iteration)``, which no torch generator reproduces).

The compact ``VDiffUNet`` runs only ``--vdiff_model tiny_test`` (every
published name runs on ``models/vdiff_upstream.py``);
``state_dict_from_flax_vdiff_unet`` brings the JAX model's flax variables
over.  Its convolutions run in the model's compute dtype; the Fourier
features, the conditioning, GroupNorm statistics, attention scores and
softmax in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def linspace(start: float, stop: float, num: int):
    """``jnp.linspace(start, stop, num)`` in float32 as XLA computes it:
    start·(1 − s) + stop·s with s = k · (1 / (num − 1)) (a division by a
    constant becomes a product with its reciprocal), the end point exact.
    The log schedule's arccos near 1 turns one ulp of t into ~1e-6."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) * torch.tensor(1.0 / div, dtype=torch.float32)
    start, stop = torch.tensor(start, dtype=torch.float32), torch.tensor(stop, dtype=torch.float32)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def t_to_alpha_sigma(t):
    return torch.cos(t * math.pi / 2), torch.sin(t * math.pi / 2)


def get_ddpm_schedule(ddpm_t):
    """Continuous DDPM noise schedule mapped to alpha/sigma t-space."""
    log_snr = -torch.log(torch.expm1(1e-4 + 10 * ddpm_t**2))
    alpha_sq = torch.sigmoid(log_snr)
    return torch.arccos(torch.sqrt(alpha_sq)) / math.pi * 2


def get_spliced_ddpm_cosine_schedule(t):
    """Cosine schedule near t=0 spliced into a DDPM schedule at larger t."""
    ddpm_crossover = 0.48536712
    cosine_crossover = 0.80074257
    big_t = t * (1 + cosine_crossover - ddpm_crossover)
    ddpm_part = get_ddpm_schedule(big_t + ddpm_crossover - cosine_crossover)
    return torch.where(big_t < cosine_crossover, big_t, ddpm_part)


def get_log_schedule(t, min_log_snr=-10, max_log_snr=10):
    log_snr = t * (min_log_snr - max_log_snr) + max_log_snr
    alpha_sq = torch.sigmoid(log_snr)
    return torch.arccos(torch.sqrt(alpha_sq)) / math.pi * 2


# ---------------------------------------------------------------------------
# stepwise sampler
# ---------------------------------------------------------------------------


@dataclass
class SampleState:
    """The schedule's t, alpha and sigma tables (float32, on the model's device)."""

    steps: torch.Tensor
    alphas: torch.Tensor
    sigmas: torch.Tensor
    eta: float = 1.0


def sample_setup(steps, eta=1.0) -> SampleState:
    alphas, sigmas = t_to_alpha_sigma(steps)
    return SampleState(steps=steps, alphas=alphas, sigmas=sigmas, eta=eta)


def at(table, i):
    """``table[i]`` as a (1,) tensor, the index clamped to the table as a
    JAX gather clamps it; ``i`` is an int or a () integer tensor (picked on
    the device with ``index_select``: indexing by a tensor synchronizes)."""
    last = table.shape[0] - 1
    if isinstance(i, torch.Tensor):
        idx = i.to(device=table.device, dtype=torch.long).clamp(0, last).reshape(1)
        return table.index_select(0, idx)
    idx = min(max(int(i), 0), last)
    return table[idx:idx + 1]


def sample_step(state: SampleState, x, i, model_fn):
    """One exposed-pred sampler step → (pred, v); ``model_fn(x, t)`` → v."""
    v = model_fn(x, at(state.steps, i))
    alpha, sigma = at(state.alphas, i), at(state.sigmas, i)
    pred = x * alpha - v * sigma
    return pred, v


def sample_noise(state: SampleState, x, i, pred, v, noise):
    """Eta-DDIM re-noising to x_{i+1}; ``noise`` is the N(0, 1) draw of x's shape."""
    alpha, sigma = at(state.alphas, i), at(state.sigmas, i)
    alpha_next, sigma_next = at(state.alphas, i + 1), at(state.sigmas, i + 1)
    eps = x * sigma + v * alpha
    ddim_sigma = (
        state.eta
        * torch.sqrt(torch.clamp(sigma_next**2 / torch.clamp(sigma**2, min=1e-12), min=0.0))
        * torch.sqrt(torch.clamp(1 - alpha**2 / torch.clamp(alpha_next**2, min=1e-12), min=0.0))
    )
    adjusted_sigma = torch.sqrt(torch.clamp(sigma_next**2 - ddim_sigma**2, min=0.0))
    return pred * alpha_next + eps * adjusted_sigma + noise * ddim_sigma


# ---------------------------------------------------------------------------
# the compact UNet (tiny_test)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VDiffConfig:
    name: str
    resolution: int
    base_ch: int
    ch_mults: tuple
    attn_depths: tuple  # depth indices with self-attention
    clip_model: str | None = None  # conditioning perceptor (cc12m family)
    clip_embed_dim: int = 512


# where the reference fetched each checkpoint (provenance only: the port never downloads)
VDIFF_CHECKPOINT_URLS = {
    "yfcc_2": "https://the-eye.eu/public/AI/models/v-diffusion/yfcc_2.pth",
    "yfcc_1": "https://the-eye.eu/public/AI/models/v-diffusion/yfcc_1.pth",
    "cc12m_1": "https://the-eye.eu/public/AI/models/v-diffusion/cc12m_1.pth",
    "cc12m_1_cfg": "https://the-eye.eu/public/AI/models/v-diffusion/cc12m_1_cfg.pth",
    "danbooru_128": "https://the-eye.eu/public/AI/models/v-diffusion/danbooru_128.pth",
    "imagenet_128": "https://the-eye.eu/public/AI/models/v-diffusion/imagenet_128.pth",
    "wikiart_128": "https://the-eye.eu/public/AI/models/v-diffusion/wikiart_128.pth",
    "wikiart_256": "https://the-eye.eu/public/AI/models/v-diffusion/wikiart_256.pth",
}

VDIFF_CONFIGS = {
    "yfcc_2": VDiffConfig("yfcc_2", 512, 64, (1, 2, 4, 8), (2, 3)),
    "yfcc_1": VDiffConfig("yfcc_1", 512, 64, (1, 2, 4, 8), (2, 3)),
    "cc12m_1": VDiffConfig("cc12m_1", 256, 64, (1, 2, 4, 8), (2, 3), clip_model="ViT-B/16"),
    "cc12m_1_cfg": VDiffConfig("cc12m_1_cfg", 256, 64, (1, 2, 4, 8), (2, 3), clip_model="ViT-B/16"),
    "danbooru_128": VDiffConfig("danbooru_128", 128, 64, (1, 2, 4), (2,)),
    "imagenet_128": VDiffConfig("imagenet_128", 128, 64, (1, 2, 4), (2,)),
    "wikiart_128": VDiffConfig("wikiart_128", 128, 64, (1, 2, 4), (2,)),
    "wikiart_256": VDiffConfig("wikiart_256", 256, 64, (1, 2, 4, 8), (2, 3)),
    # tiny model for CI
    "tiny_test": VDiffConfig("tiny_test", 64, 16, (1, 2), (1,)),
}


def fourier_features(t, weight):
    """cat(cos, sin) of 2π·t @ weightᵀ in float32; t (B, in), weight (out/2, in)."""
    f = 2 * math.pi * (t.float() @ weight.float().T)
    return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


class CompactResConvBlock(nn.Module):
    """relu(conv(relu(conv(x))) + skip(x)); the skip a bias-free 1x1 conv
    where the channel count changes."""

    def __init__(self, c_in: int, c_mid: int, c_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_mid, 3, padding=1)
        self.conv2 = nn.Conv2d(c_mid, c_out, 3, padding=1)
        self.skip = nn.Conv2d(c_in, c_out, 1, bias=False) if c_in != c_out else None

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        return F.relu(h + (x if self.skip is None else self.skip(x)))


class CompactSelfAttention2d(nn.Module):
    """GroupNorm(min(32, c // 4), eps 1e-6), then q/k/v outermost in the
    channels (q = channels [0, c)), each split into heads; the scale
    (c // n_head) ** -0.5 on q only."""

    def __init__(self, c: int, n_head: int = 4):
        super().__init__()
        self.n_head = n_head
        self.groups = min(32, c // 4)
        self.norm = nn.GroupNorm(self.groups, c, eps=1e-6)
        self.qkv = nn.Conv2d(c, c * 3, 1)
        self.out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        d = c // self.n_head
        y = F.group_norm(x.float(), self.groups, self.norm.weight, self.norm.bias, self.norm.eps).to(x.dtype)
        q, k, v = self.qkv(y).reshape(b, 3, self.n_head, d, h * w).unbind(1)
        scores = torch.matmul((q.float() * d**-0.5).transpose(2, 3), k.float())  # (b, head, q, k)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(v, attn.transpose(2, 3)).reshape(b, c, h, w)
        return x + self.out(out)


class VDiffUNet(nn.Module):
    """Recursive skip-connection UNet with timestep (+ optional clip)
    conditioning broadcast as input planes; x (B, 3, H, W) → v."""

    def __init__(self, config: VDiffConfig):
        super().__init__()
        cfg = self.config = config
        self.timestep_embed = nn.Parameter(torch.zeros(32, 1))  # FourierFeatures(64): (out/2, in)
        self.t_proj = nn.Linear(64, cfg.base_ch)
        self.clip_proj = nn.Linear(cfg.clip_embed_dim, cfg.base_ch) if cfg.clip_model else None
        depths = len(cfg.ch_mults)
        self.down, self.up = nn.ModuleList(), nn.ModuleList()
        c_prev = 3 + cfg.base_ch
        skips = []
        for d in range(depths):
            c = cfg.base_ch * cfg.ch_mults[d]
            self.down.append(self._level(c_prev, c, d))
            c_prev = c
            if d != depths - 1:
                skips.append(c)
        for d in range(depths - 2, -1, -1):
            c = cfg.base_ch * cfg.ch_mults[d]
            self.up.append(self._level(c_prev + skips.pop(), c, d))
            c_prev = c
        self.out_conv = nn.Conv2d(c_prev, 3, 3, padding=1)

    def _level(self, c_in, c, d):
        blocks = [CompactResConvBlock(c_in, c, c), CompactResConvBlock(c, c, c)]
        if d in self.config.attn_depths:
            blocks.append(CompactSelfAttention2d(c))
        return nn.Sequential(*blocks)

    @property
    def compute_dtype(self):
        return self.out_conv.weight.dtype

    def to_compute_dtype(self, dtype):
        """Convolutions in ``dtype``; the conditioning and the norms stay f32."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)
        return self

    def forward(self, x, t, clip_embed=None):
        cfg = self.config
        t = t.float().reshape(-1, 1)
        cond = self.t_proj(fourier_features(t, self.timestep_embed))
        if self.clip_proj is not None:
            ce = torch.zeros((1, cfg.clip_embed_dim), device=x.device) if clip_embed is None else clip_embed.float()
            cond = cond + self.clip_proj(ce.reshape(-1, cfg.clip_embed_dim))
        cond = F.relu(cond)
        b, _, h, w = x.shape
        dtype = self.compute_dtype
        cond_map = cond[:, :, None, None].expand(b, cond.shape[-1], h, w)
        hidden = torch.cat([x.float(), cond_map], dim=1).to(dtype)
        skips = []
        for d, level in enumerate(self.down):
            hidden = level(hidden)
            if d != len(self.down) - 1:
                skips.append(hidden)
                hidden = F.avg_pool2d(hidden, 2)
        for level in self.up:
            hidden = F.interpolate(hidden, scale_factor=2, mode="nearest")
            hidden = level(torch.cat([hidden, skips.pop()], dim=1))
        return self.out_conv(hidden).float()


def _conv_from_flax(out, name, p):
    out[f"{name}.weight"] = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"], np.float32)


def state_dict_from_flax_vdiff_unet(params, config: VDiffConfig) -> dict:
    """The JAX ``VDiffUNet``'s ``"params"`` collection → this module's
    state dict (float32 numpy): HWIO → OIHW, Dense (in, out) → (out, in)."""
    out = {"timestep_embed": np.asarray(params["timestep_embed"]["weight"], np.float32)}
    for name in ("t_proj", "clip_proj"):
        if name in params:
            out[f"{name}.weight"] = np.asarray(params[name]["kernel"], np.float32).T
            out[f"{name}.bias"] = np.asarray(params[name]["bias"], np.float32)
    depths = len(config.ch_mults)
    levels = [("down", d, f"down.{d}") for d in range(depths)]
    levels += [("up", d, f"up.{i}") for i, d in enumerate(range(depths - 2, -1, -1))]
    for kind, d, path in levels:
        for j, res in enumerate(("res1", "res2")):
            block = params[f"{kind}_{d}_{res}"]
            _conv_from_flax(out, f"{path}.{j}.conv1", block["Conv_0"])
            _conv_from_flax(out, f"{path}.{j}.conv2", block["Conv_1"])
            if "Conv_2" in block:
                _conv_from_flax(out, f"{path}.{j}.skip", block["Conv_2"])
        if d in config.attn_depths:
            attn = params[f"{kind}_{d}_attn"]
            out[f"{path}.2.norm.weight"] = np.asarray(attn["GroupNorm_0"]["scale"], np.float32)
            out[f"{path}.2.norm.bias"] = np.asarray(attn["GroupNorm_0"]["bias"], np.float32)
            _conv_from_flax(out, f"{path}.2.qkv", attn["Conv_0"])
            _conv_from_flax(out, f"{path}.2.out", attn["Conv_1"])
    _conv_from_flax(out, "out_conv", params["out_conv"])
    return out
