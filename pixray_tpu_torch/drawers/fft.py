"""FFT drawer: an image parameterized in Fourier, wavelet or pixel space
(port of ``pixray_tpu/drawers/fft.py``).

- ``fft``: the latent is the rfft2 spectrum as a (3, h, w//2+1, 2) real /
  imaginary pair, scaled by ``freq^-decay``, rendered by
  ``torch.fft.irfftn(norm="ortho")`` (cuFFT on the card);
- ``dwt``: the latent is a wavelet pyramid, a dict of ``ll`` and
  ``bands0..3`` (``--fft_wave``, default coif2), rendered level by level as
  ``A_h.T @ y @ A_w`` with the orthogonal analysis matrices of
  ``ops/wavelets.py``;
- ``pixel``: the latent is the (3, h, w) logits;

then the colour decorrelation, the render-time contrast 0.9 and a sigmoid.
The constants (the spectrum's scale, the colour matrix, the wavelet
matrices) are made once in ``snap_canvas`` as the drawer's
``model_params``, which the engine moves to the device once.
"""

from __future__ import annotations

import numpy as np
import torch

from pixray_tpu_torch.ops.wavelets import analysis_matrix, wavelet_filter

# Lucid colour-decorrelation matrix (ImageNet empirical colour SVD sqrt)
_COLOR_SVD_SQRT = np.asarray(
    [[0.26, 0.09, 0.02], [0.27, 0.00, -0.05], [0.27, -0.09, 0.03]], np.float32
)
_COLOR_NORM = _COLOR_SVD_SQRT / np.max(np.linalg.norm(_COLOR_SVD_SQRT, axis=0))
_MAGIC = 4.0  # Lucid's empirical scaling constant
DWT_LEVELS = 4


def fft_scale(h, w, decay_power) -> torch.Tensor:
    """(1, h, w//2+1) float32 spectrum scale."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    freqs = np.sqrt(fx**2 + fy**2)
    freqs = np.maximum(freqs, 1.0 / max(h, w))
    scale = 1.0 / freqs**decay_power
    scale *= np.sqrt(h * w)
    return torch.from_numpy(scale[None].astype(np.float32))


def dwt2(x, a_h, a_w):
    """One separable analysis level: (C, H, W) → LL, (LH, HL, HH)."""
    y = a_h @ x @ a_w.mT
    h2, w2 = a_h.shape[0] // 2, a_w.shape[0] // 2
    return y[:, :h2, :w2], (y[:, :h2, w2:], y[:, h2:, :w2], y[:, h2:, w2:])


def idwt2(ll, bands, a_h, a_w):
    """The exact inverse of :func:`dwt2` (synthesis = transposed matrices)."""
    lh, hl, hh = bands
    y = torch.cat([torch.cat([ll, lh], dim=2), torch.cat([hl, hh], dim=2)], dim=1)
    return a_h.mT @ y @ a_w


class FftDrawer:
    @staticmethod
    def add_settings(parser):
        parser.add_argument("--fft_use", type=str, help="use fft or dwt or pixel", default="fft", dest="fft_use")
        parser.add_argument("--fft_decay", default=1.5, type=float, dest="fft_decay")
        parser.add_argument("--fft_wave", default="coif2", help="wavelets: db[1..20], coif[1..5], haar", dest="fft_wave")
        parser.add_argument("--fft_sharp", default=0.3, type=float, dest="fft_sharp")
        parser.add_argument("--fft_colors", default=1.5, type=float, dest="fft_colors")
        parser.add_argument("--fft_lrate", default=0.3, type=float, help="Learning rate", dest="fft_lrate")
        return parser

    def __init__(self, settings):
        self.canvas_width, self.canvas_height = settings.size
        self.fft_use = settings.fft_use
        if self.fft_use not in ("fft", "dwt", "pixel"):
            raise ValueError(f"fft drawer does not know how to apply fft_use={self.fft_use}")
        self.decay = settings.fft_decay
        self.colors = settings.fft_colors
        self.learning_rate = settings.fft_lrate
        self.contrast = 0.9
        self.dec_lo = wavelet_filter(settings.fft_wave) if self.fft_use == "dwt" else None  # raises on unknown names
        self.model_params = {}

    def snap_canvas(self, size):
        self.canvas_width, self.canvas_height = size
        mp = {"color": torch.from_numpy(_COLOR_NORM * self.colors)}
        if self.fft_use == "fft":
            mp["scale"] = fft_scale(self.canvas_height, self.canvas_width, self.decay)
        elif self.fft_use == "dwt":
            ph, pw = self._dwt_shapes()
            # level 0 is the coarsest, as the bands{lvl} pyramid is applied upward
            for lvl in range(DWT_LEVELS):
                shift = DWT_LEVELS - 1 - lvl
                mp[f"dwt{lvl}_h"] = torch.from_numpy(analysis_matrix(ph >> shift, self.dec_lo).astype(np.float32))
                mp[f"dwt{lvl}_w"] = torch.from_numpy(analysis_matrix(pw >> shift, self.dec_lo).astype(np.float32))
        self.model_params = mp
        return self.canvas_width, self.canvas_height

    # ------------------------------------------------------------------ latents
    def _dwt_shapes(self):
        f = 2**DWT_LEVELS
        return -(-self.canvas_height // f) * f, -(-self.canvas_width // f) * f

    def init_params(self, gen, init_tensor=None):
        if init_tensor is not None:
            return self.params_from_image(init_tensor)
        h, w = self.canvas_height, self.canvas_width
        if self.fft_use == "fft":
            return torch.randn((3, h, w // 2 + 1, 2), generator=gen) * 0.01
        if self.fft_use == "dwt":
            ph, pw = self._dwt_shapes()
            params = {"ll": torch.randn((3, ph >> DWT_LEVELS, pw >> DWT_LEVELS), generator=gen) * 0.1}
            for lvl in range(DWT_LEVELS):
                shift = DWT_LEVELS - lvl
                params[f"bands{lvl}"] = torch.randn((3, 3, ph >> shift, pw >> shift), generator=gen) * 0.1
            return params
        return torch.randn((3, h, w), generator=gen)

    def params_from_image(self, image_tensor):
        """The latent that renders ``image_tensor`` ((H, W, 3) in [-1, 1])."""
        mp = self.model_params
        img01 = ((torch.as_tensor(image_tensor, dtype=torch.float32) + 1.0) / 2.0).clamp(1e-3, 1 - 1e-3)
        logits = torch.log(img01 / (1.0 - img01))
        inv = torch.from_numpy(np.linalg.inv(_COLOR_NORM * self.colors)).to(logits.device)
        raw = (logits @ inv.T).permute(2, 0, 1) / self.contrast  # (3, H, W)
        if self.fft_use == "fft":
            spectrum = torch.fft.rfftn(raw * _MAGIC, dim=(1, 2), norm="ortho") / mp["scale"].to(raw.device)
            return torch.stack([spectrum.real, spectrum.imag], dim=-1)
        if self.fft_use == "dwt":
            ph, pw = self._dwt_shapes()
            x = torch.nn.functional.pad(raw[None], (0, pw - raw.shape[2], 0, ph - raw.shape[1]),
                                        mode="replicate")[0]
            params = {}
            for lvl in range(DWT_LEVELS - 1, -1, -1):
                x, bands = dwt2(x, mp[f"dwt{lvl}_h"].to(x.device), mp[f"dwt{lvl}_w"].to(x.device))
                params[f"bands{lvl}"] = torch.stack(bands, dim=0)
            params["ll"] = x
            return params
        return raw

    def clip_params(self, z):
        return z

    # ------------------------------------------------------------------- render
    def synth(self, model_params, z, iteration=None):
        """The latent → (H, W, 3) canvas in (0, 1)."""
        h, w = self.canvas_height, self.canvas_width
        if self.fft_use == "fft":
            spectrum = torch.complex(z[..., 0], z[..., 1]) * model_params["scale"]
            raw = torch.fft.irfftn(spectrum, s=(h, w), dim=(1, 2), norm="ortho") / _MAGIC
        elif self.fft_use == "dwt":
            x = z["ll"]
            for lvl in range(DWT_LEVELS):
                b = z[f"bands{lvl}"]
                x = idwt2(x, (b[0], b[1], b[2]), model_params[f"dwt{lvl}_h"], model_params[f"dwt{lvl}_w"])
            raw = x[:, :h, :w]
        else:
            raw = z
        img = raw.permute(1, 2, 0) * self.contrast
        return torch.sigmoid(img @ model_params["color"].T)
