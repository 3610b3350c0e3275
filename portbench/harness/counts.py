"""Operations and bytes of a step, counted from a configuration's shapes.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM3.

A step's model FLOPs (``step_flops``) count each tower's image forward
over all cuts and its input gradient (the towers are frozen: no weight
gradients), the decoder's forward and input gradient, and the drawer's
matmuls.  An input gradient costs what the forward costs for every matmul
or convolution whose other operand is a constant, and twice that for
attention's two products, whose operands both depend on the input.

The cutout bank's least time (``bank_bound_s``) follows its function: K1
reads the float32 work canvas, the parameter rows and the bf16 noise
planes, writes the bf16 bank and, for the jittered cuts, the pre-jitter
bank; K2 reads the bank's cotangent and the pre-jitter rows, and writes the
canvas gradient.  Operations per output pixel: the warp's coordinates,
taps and bilinear sums, the HSV round trip of a jittered cut, and their
adjoints.
"""

from __future__ import annotations

BF16_PEAK_FLOPS = 989e12
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

WARP_FWD_FLOPS_PER_PIXEL = 55  # coordinates and taps ~25, 3-channel bilinear 24, noise 6
JITTER_FWD_FLOPS_PER_PIXEL = 45  # HSV round trip
WARP_BWD_FLOPS_PER_PIXEL = 49  # taps ~25, the 12 tap products 24
JITTER_BWD_FLOPS_PER_PIXEL = 110  # HSV state ~35, its adjoint ~75
PARAM_ROW_BYTES = 16 * 4  # one cut's float32 parameter row
BANK_ELEMENT_BYTES = 2  # bf16 bank, noise and pre-jitter planes


def tower_step_flops(d: dict, cuts: int, bench_dir: str | None = None) -> float:
    """A tower's step over ``cuts`` cuts: each image's forward and input
    gradient, its FLOPs as its kind counts them (``image_flops`` of
    ``reference/towers/<kind>.py``)."""
    from portbench.reference import towers

    f = towers.module(towers.kind_of(d), bench_dir).image_flops(d)
    return cuts * (2 * f["linear"] + 3 * f["attention"])


def decoder_forward_flops(d: dict, height: int, width: int) -> dict:
    """The VQGAN's post-quant conv and decoder forward on an (height,
    width) canvas: {"conv": every convolution, "attention": the score and
    value products, "distance": the nearest-code cross products}."""
    levels = len(d["ch_mult"])
    h, w = height // 2 ** (levels - 1), width // 2 ** (levels - 1)
    tokens = h * w
    conv = lambda cin, cout, k, hh, ww: 2 * cin * k * k * cout * hh * ww
    res = d["resolution"] // 2 ** (levels - 1)
    cin = d["ch"] * d["ch_mult"][-1]
    lin = conv(d["embed_dim"], d["z_channels"], 1, h, w) + conv(d["z_channels"], cin, 3, h, w)
    att = 0

    def resnet(a, b, hh, ww):
        return conv(a, b, 3, hh, ww) + conv(b, b, 3, hh, ww) + (conv(a, b, 1, hh, ww) if a != b else 0)

    def attn(c, hh, ww):
        return conv(c, c, 1, hh, ww) * 4, 4 * (hh * ww) ** 2 * c

    lin += 2 * resnet(cin, cin, h, w)
    a_lin, a_att = attn(cin, h, w)
    lin, att = lin + a_lin, att + a_att
    for i in reversed(range(levels)):
        cout = d["ch"] * d["ch_mult"][i]
        for _ in range(d["num_res_blocks"] + 1):
            lin += resnet(cin, cout, h, w)
            cin = cout
            if res in d["attn_resolutions"]:
                a_lin, a_att = attn(cin, h, w)
                lin, att = lin + a_lin, att + a_att
        if i != 0:
            h, w, res = 2 * h, 2 * w, 2 * res
            lin += conv(cin, cin, 3, h, w)
    lin += conv(cin, 3, 3, h, w)
    return {"conv": lin, "attention": att, "distance": 2 * tokens * d["n_embed"] * d["embed_dim"]}


def decoder_step_flops(d: dict, height: int, width: int) -> float:
    """The VQGAN drawer's step: the decoder forward and input gradient, and
    the nearest-code distances (forward only)."""
    f = decoder_forward_flops(d, height, width)
    return 2 * f["conv"] + 3 * f["attention"] + f["distance"]


def pixel_step_flops(height: int, width: int, rows: int, cols: int) -> float:
    """The rect grid's two matmuls, forward and input gradient."""
    return 2 * (2 * height * rows * cols * 4 + 2 * height * cols * 4 * width)


def bank_bound_s(cuts: int, jittered: int, cut: int, canvas: tuple[int, int]) -> tuple[float, float]:
    """(K1's, K2's) least seconds for one bank of ``cuts`` cuts of
    ``cut`` x ``cut`` from a float32 (canvas[0], canvas[1], 3) work canvas,
    ``jittered`` of them jittered."""
    plane = cut * cut * BANK_ELEMENT_BYTES
    work = canvas[0] * canvas[1] * 3 * 4
    rows = cuts * PARAM_ROW_BYTES
    f_bytes = work + rows + 3 * cuts * plane * 2 + 3 * jittered * plane
    b_bytes = 3 * cuts * plane + 3 * jittered * plane + rows + work
    f_ops = (WARP_FWD_FLOPS_PER_PIXEL * cuts + JITTER_FWD_FLOPS_PER_PIXEL * jittered) * cut * cut
    b_ops = (WARP_BWD_FLOPS_PER_PIXEL * cuts + JITTER_BWD_FLOPS_PER_PIXEL * jittered) * cut * cut
    return (max(f_bytes / HBM_BYTES_PER_S, f_ops / F32_PEAK_FLOPS),
            max(b_bytes / HBM_BYTES_PER_S, b_ops / F32_PEAK_FLOPS))


def step_flops(settings: dict) -> float:
    """A step's model FLOPs for a cell's reference settings
    (``cell.reference_settings``): every tower, then the drawer's own count
    (``synth_flops`` of ``reference/drawers/<drawer>.py``)."""
    import importlib

    drawer = importlib.import_module(f"portbench.reference.drawers.{settings['drawer']}")
    towers = sum(tower_step_flops(settings["towers"][name], settings["num_cuts"], settings.get("bench_dir"))
                 for name in settings["clip_models"])
    return towers + drawer.synth_flops(settings)
