"""Settings: two-pass argparse + optional YAML + kwargs, with drawer flag injection.

The same flag table, preset matrices and resolution rules as
``pixray_tpu/config/settings.py``, so a settings dict resolves to the same
namespace in both packages.  Differences:

- the drawer, filter and loss registries are this package's own
  (``drawers``, ``filters`` and ``losses``);
- ``yaml`` is imported only where a YAML file is read or the
  ``settings.yaml`` dump is written, so the package runs without PyYAML.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from types import SimpleNamespace

from pixray_tpu_torch.drawers import drawer_class
from pixray_tpu_torch.filters import filter_class
from pixray_tpu_torch.losses import loss_class
from pixray_tpu_torch.prompt import parse_prompt
from pixray_tpu_torch.utils import (
    emit_filename,
    get_file_path,
    palette_from_string,
    parse_unit,
    real_glob,
    split_pipes,
    str2bool,
)

QUALITY_TO_CLIP_MODELS = {
    "clip": {
        "draft": "ViT-B/16",
        "normal": "ViT-B/32,ViT-B/16",
        "better": "RN50,ViT-B/32,ViT-B/16",
        "best": "RN50x4,ViT-B/32,ViT-B/16",
        "supreme": "RN50x4,RN101,ViT-B/32,ViT-B/16",
    },
    "slip": {
        "draft": "SLIP_VITB16",
        "normal": "SLIP_VITB16,SLIP_CC3M",
        "better": "SLIP_VITB16,SLIP_CC3M,SLIP_CC12M",
        "best": "SLIP_VITB16,SLIP_CC3M,SLIP_CC12M,SLIP_VITS16",
        "supreme": "SLIP_VITB16,SLIP_CC3M,SLIP_CC12M,SLIP_VITS16,SLIP_VITL16",
    },
    "mixed": {
        "draft": "ViT-B/16",
        "normal": "ViT-B/16,SLIP_VITB16",
        "better": "RN50,ViT-B/16,SLIP_VITB16",
        "best": "RN50x4,ViT-B/16,SLIP_VITB16",
        "supreme": "RN50x4,RN101,ViT-B/16,SLIP_VITB16",
    },
}

QUALITY_TO_ITERATIONS = {"draft": 200, "normal": 250, "better": 300, "best": 350, "supreme": 400}
QUALITY_TO_SCALE = {"draft": 1, "normal": 2, "better": 3, "best": 4, "supreme": 5}
QUALITY_TO_NUM_CUTS = {"draft": 24, "normal": 30, "better": 36, "best": 12, "supreme": 8}
QUALITY_TO_BATCHES = {"draft": 1, "normal": 1, "better": 1, "best": 2, "supreme": 4}

SIZE_TO_SCALE = {"small": 1, "medium": 2, "large": 4}
ASPECT_TO_SIZE = {"square": [144, 144], "portrait": [128, 160], "widescreen": [192, 108]}


def setup_parser(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Core engine flags: the JAX package's names and defaults."""
    a = parser.add_argument
    a("-p", "--prompts", type=str, help="Text prompts", default=[], dest="prompts")
    a("-sp", "--spot", type=str, help="Spot Text prompts", default=[], dest="spot_prompts")
    a("-spo", "--spot_off", type=str, help="Spot off Text prompts", default=[], dest="spot_prompts_off")
    a("-spf", "--spot_file", type=str, help="Custom spot file", default=None, dest="spot_file")
    a("-l", "--labels", type=str, help="ImageNet labels", default=[], dest="labels")
    a("-vp", "--vector_prompts", type=str, help="Vector prompts", default="textoff", dest="vector_prompts")
    a("-ip", "--image_prompts", type=str, help="Image prompts", default=[], dest="image_prompts")
    a("-ipw", "--image_prompt_weight", type=float, help="Weight for image prompt", default=None, dest="image_prompt_weight")
    a("-ips", "--image_prompt_shuffle", type=str2bool, help="Shuffle image prompts", default=False, dest="image_prompt_shuffle")
    a("-il", "--image_labels", type=str, help="Image label images", default=None, dest="image_labels")
    a("-ilw", "--image_label_weight", type=float, help="Weight for image label", default=1.0, dest="image_label_weight")
    a("-i", "--iterations", type=int, help="Number of iterations", default=None, dest="iterations")
    a("-se", "--save_every", type=str, help="Save image iterations", default=10, dest="save_every")
    a("-si", "--save_intermediates", type=str2bool, help="Save intermediate frames", default=True, dest="save_intermediates")
    a("-de", "--display_every", type=str, help="Display image iterations", default=20, dest="display_every")
    a("-dc", "--display_clear", type=str2bool, help="Clear display when updating", default=False, dest="display_clear")
    a("-ove", "--overlay_every", type=str, help="Overlay image iterations", default="10 iterations", dest="overlay_every")
    a("-ovo", "--overlay_offset", type=str, help="Overlay image iteration offset", default="0 iterations", dest="overlay_offset")
    a("-ovu", "--overlay_until", type=str, help="Last overlay iteration", default=None, dest="overlay_until")
    a("-ovi", "--overlay_image", type=str, help="Overlay image (if not init)", default=None, dest="overlay_image")
    a("--quality", type=str, help="draft, normal, better, best, supreme", default="normal", dest="quality")
    a("-asp", "--aspect", type=str, help="widescreen, square, portrait, retain", default="widescreen", dest="aspect")
    a("-ezs", "--ezsize", type=str, help="small, medium, large", default=None, dest="ezsize")
    a("-sca", "--scale", type=float, help="scale (instead of ezsize)", default=None, dest="scale")
    a("-ova", "--overlay_alpha", type=int, help="Overlay alpha (0-255)", default=None, dest="overlay_alpha")
    a("-s", "--size", nargs=2, type=int, help="Image size (width height)", default=None, dest="size")
    a("-ii", "--init_image", type=str, help="Initial image", default=None, dest="init_image")
    a("-iia", "--init_image_alpha", type=int, help="Init image alpha (0-255)", default=200, dest="init_image_alpha")
    a("-in", "--init_noise", type=str, help="Initial noise image (pixels/gradient/snow)", default="pixels", dest="init_noise")
    a("-ti", "--target_images", type=str, help="Target images", default=None, dest="target_images")
    a("-anim", "--animation_dir", type=str, help="Animation output dir", default=None, dest="animation_dir")
    a("-ana", "--animation_alpha", type=int, help="Forward blend for consistency", default=128, dest="animation_alpha")
    a("-iw", "--init_weight", type=float, help="Initial weight (main=spherical)", default=None, dest="init_weight")
    a("-iwd", "--init_weight_dist", type=float, help="Initial weight dist loss", default=0.0, dest="init_weight_dist")
    a("-iwc", "--init_weight_cos", type=float, help="Initial weight cos loss", default=0.0, dest="init_weight_cos")
    a("-iwp", "--init_weight_pix", type=float, help="Initial weight pix loss", default=0.0, dest="init_weight_pix")
    a("--perceptors", type=str, help="perceptors (clip/slip/mixed)", default="clip", dest="perceptors")
    a("--clip_models", type=str, help="CLIP model list", default=None, dest="clip_models")
    a("-nps", "--noise_prompt_seeds", nargs="*", type=int, help="Noise prompt seeds", default=[], dest="noise_prompt_seeds")
    a("-npw", "--noise_prompt_weights", nargs="*", type=float, help="Noise prompt weights", default=[], dest="noise_prompt_weights")
    a("-lr", "--learning_rate", type=float, help="Learning rate", default=0.2, dest="learning_rate")
    a("-lrd", "--learning_rate_drops", nargs="*", type=str, help="When to drop learning rate (relative to iterations)", default=[75], dest="learning_rate_drops")
    a("-as", "--auto_stop", type=str2bool, help="Auto stopping", default=False, dest="auto_stop")
    a("-cuts", "--num_cuts", type=int, help="Number of cuts", default=None, dest="num_cuts")
    a("-bats", "--batches", type=int, help="How many batches of cuts", default=None, dest="batches")
    a("-cutp", "--cut_power", type=float, help="Cut power", default=1.0, dest="cut_pow")
    a("--seed", type=str, help="Seed (int or string)", default=None, dest="seed")
    a("-opt", "--optimiser", type=str, help="Optimiser", default="Adam", dest="optimiser")
    a("-vid", "--video", type=str2bool, help="Create video frames?", default=False, dest="make_video")
    a("-d", "--deterministic", type=str2bool, help="Deterministic mode", default=False, dest="cudnn_determinism")
    a("-cud", "--cuda_device", type=str, help="(compat; the device is Engine's argument)", default=None, dest="cuda_device")
    a("--palette", type=str, help="target palette", default=None, dest="palette")
    a("--transparent", type=str2bool, help="enable transparent outputs", default=False, dest="transparent")
    a("--transparent_weight", type=float, help="strength of transparent loss", default=0.0, dest="transparent_weight")
    a("--alpha_use_g", type=str2bool, help="use gaussian mask weighting", default=False, dest="alpha_use_g")
    a("--alpha_gamma", type=float, help="width-relative sigma for the alpha gaussian", default=4.0, dest="alpha_gamma")
    a("--output", type=str, help="Output filename", default="output.png", dest="output")
    a("--outdir", type=str, help="Output file directory", default="outputs/%DATE%_%SEQ%", dest="outdir")
    # the mesh over the ranks of a process group (parallel/mesh.py); one rank runs unsharded
    a("--mesh_shape", type=str, help="device mesh over the process group's ranks: auto (every rank on the data axis), D, D,M or hosts", default="auto", dest="mesh_shape")
    a("--shard_cutouts", type=str2bool, help="join the configured process group and split each step's cutouts (and, on a model axis, the perceptors) over its ranks", default=True, dest="shard_cutouts")
    a("--precision", type=str, help="perceptor compute precision: bf16 or fp32", default="bf16", dest="precision")
    a("--checkpoint_every", type=str, help="save a resumable session checkpoint every N iterations (0=off)", default=0, dest="checkpoint_every")
    a("--resume_from", type=str, help="resume a session from a checkpoint file", default=None, dest="resume_from")
    a("--profile_dir", type=str, help="write a torch.profiler trace of the run into this directory", default=None, dest="profile_dir")
    a("--steps_per_call", type=int, help="optimizer steps per dispatch (0=auto blocks of 8 DEFAULT; 1=single-step; N>1=fixed block size); on the card a block is one replay of a captured CUDA graph; host events (save/LR drops) split blocks automatically", default=0, dest="steps_per_call")
    a("--save_svg", type=str2bool, help="export vector drawers to SVG at the end of the run", default=False, dest="save_svg")
    return parser


def get_learning_rate_drops(learning_rate_drops, iterations):
    """Percent→iteration conversion for LR drop points."""
    if learning_rate_drops is None:
        return []
    return [parse_unit(n, iterations - 1, "learning_rate_drops") for n in learning_rate_drops]


def parse_known_args_with_optional_yaml(parser, namespace=None, use_argv=True):
    """First-pass parse with optional ``--config_file`` YAML merge."""
    parser.add_argument("--config_file", dest="config_file", type=argparse.FileType(mode="r"))
    arguments, unknown = parser.parse_known_args(
        args=(None if use_argv else []), namespace=namespace
    )
    if arguments.config_file:
        import yaml

        config_file = arguments.config_file
        if isinstance(config_file, str):  # kwargs channel delivers a path, not a handle
            config_file = open(config_file, mode="r")
        data = yaml.load(config_file, Loader=yaml.SafeLoader)
        delattr(arguments, "config_file")
        arg_dict = arguments.__dict__
        for key, value in data.items():
            if isinstance(value, list):
                if key not in arg_dict or arg_dict[key] is None:
                    arg_dict[key] = []
                for v in value:
                    arg_dict[key].append(v)
            else:
                arg_dict[key] = value
    return arguments, unknown


def initialize_logging(settings_core, settings_dict):
    """Per-run debug log + non-default settings.yaml dump (skipped without PyYAML)."""
    if settings_core.outdir is not None and settings_core.outdir.strip() != "":
        logfile = get_file_path(settings_core.outdir, settings_core.output, ".log")
        logging.basicConfig(level=logging.DEBUG, filename=logfile, filemode="w+")
        try:
            import yaml
        except ImportError:
            print("PyYAML not installed: settings.yaml not written")
            return
        with open(os.path.join(settings_core.outdir, "settings.yaml"), "w+") as ff:
            yaml.dump(settings_dict, ff, allow_unicode=True, default_flow_style=False)


def process_args(parser, namespace=None, apply_side_effects=True, use_argv=False):
    """Second-pass parse: presets, sizes, units, pipes.

    ``apply_side_effects=False`` skips directory creation and logging init.
    ``use_argv`` lets CLI flags override namespace values.
    """
    if namespace is None:
        args = parser.parse_args()
    elif use_argv and not hasattr(namespace, "skip_args"):
        args = parser.parse_args(namespace=namespace)
    else:
        args = parser.parse_args(args=[], namespace=namespace)

    # the YAML merge already happened in pass 1; drop the (unserializable) handle
    if getattr(args, "config_file", None) is not None:
        args.config_file.close()
        args.config_file = None

    given_args = {
        opt.dest: getattr(args, opt.dest)
        for opt in parser._option_string_actions.values()
        if hasattr(args, opt.dest)
        and opt.default != getattr(args, opt.dest)
        and opt.dest != "config_file"
    }
    args.given_args = given_args

    if apply_side_effects:
        args.outdir = emit_filename(args.outdir)
        if args.outdir != "" and not os.path.exists(args.outdir):
            os.makedirs(args.outdir)
        initialize_logging(args, given_args)

    if args.quality not in QUALITY_TO_CLIP_MODELS[args.perceptors]:
        raise ValueError(f"Quality setting not understood: {args.quality}")

    if args.clip_models is None:
        args.clip_models = QUALITY_TO_CLIP_MODELS[args.perceptors][args.quality]
    if args.iterations is None:
        args.iterations = QUALITY_TO_ITERATIONS[args.quality]
    if args.num_cuts is None:
        args.num_cuts = QUALITY_TO_NUM_CUTS[args.quality]
    if args.batches is None:
        args.batches = QUALITY_TO_BATCHES[args.quality]
    if args.ezsize is None and args.scale is None:
        args.scale = QUALITY_TO_SCALE[args.quality]

    if args.size is None:
        size_scale = args.scale
        if size_scale is None:
            if args.ezsize in SIZE_TO_SCALE:
                size_scale = SIZE_TO_SCALE[args.ezsize]
            else:
                raise ValueError(f"EZ Size not understood: {args.ezsize}")
        if args.aspect in ASPECT_TO_SIZE:
            base_size = ASPECT_TO_SIZE[args.aspect]
            args.size = [int(size_scale * base_size[0]), int(size_scale * base_size[1])]
        elif args.aspect == "retain" and args.init_image is not None:
            from PIL import Image

            w, h = Image.open(real_glob(args.init_image)[0]).size
            args.size = [int(144 * size_scale), int(144 * (h / w) * size_scale)]
        else:
            raise ValueError(f"aspect not understood: {args.aspect}")

    args.aspect_width = args.size[0] / args.size[1]

    if isinstance(args.init_noise, str) and args.init_noise.lower() == "none":
        args.init_noise = None

    args.prompts = split_pipes(args.prompts)
    args.target_images = split_pipes(args.target_images)
    args.spot_prompts = split_pipes(args.spot_prompts)
    args.spot_prompts_off = split_pipes(args.spot_prompts_off)
    args.labels = split_pipes(args.labels)

    args.overlay_offset = parse_unit(args.overlay_offset, args.iterations, "overlay_offset", "i")
    args.overlay_until = parse_unit(args.overlay_until, args.iterations, "overlay_until", "i")
    args.overlay_every = parse_unit(args.overlay_every, args.iterations, "overlay_every", "i")
    args.display_every = parse_unit(args.display_every, args.iterations, "display_every", "i")
    args.save_every = parse_unit(args.save_every, args.iterations, "save_every", "i")
    args.checkpoint_every = parse_unit(args.checkpoint_every, args.iterations, "checkpoint_every", "i")

    if args.image_prompts:
        args.image_prompts = real_glob(args.image_prompts)

    if args.vector_prompts:
        if args.vector_prompts.lower() == "none" or args.vector_prompts == "0":
            args.vector_prompts = []
        else:
            args.vector_prompts = [p.strip() for p in args.vector_prompts.split("|")]
    else:
        args.vector_prompts = []

    if args.palette is not None and isinstance(args.palette, str):
        args.palette = palette_from_string(args.palette)

    if args.overlay_image is not None and args.overlay_every <= 0:
        args.overlay_image = None

    args.clip_models = [m.strip() for m in args.clip_models.split(",")]

    if args.make_video and apply_side_effects:
        video_folder = os.path.join(args.outdir, "video")
        if not os.path.exists(video_folder):
            os.mkdir(video_folder)

    args.learning_rate_drops = get_learning_rate_drops(args.learning_rate_drops, args.iterations)
    args.max_loss_drops = len(args.learning_rate_drops)

    return args


def apply_settings(settings_dict: dict, apply_side_effects=True):
    """Full two-pass settings resolution.

    Pass 1 discovers the drawer, filters and losses so they can inject their
    own flags; pass 2 parses everything with unknown-key validation.
    """
    parser = argparse.ArgumentParser(description="CLIP-guided image generation (PyTorch port)")
    parser.add_argument("--drawer", type=str, help="clipdraw, pixel, etc", default="vqgan", dest="drawer")
    parser.add_argument("--filters", type=str, help="Image filtering", default=None, dest="filters")
    parser.add_argument("--losses", "--custom_loss", type=str, help="custom loss list, e.g. 'edge,smoothness:0.5'", default=None, dest="custom_loss")

    use_argv = not settings_dict
    namespace = SimpleNamespace(**settings_dict) if settings_dict else SimpleNamespace()
    settings_core, _unknown = parse_known_args_with_optional_yaml(
        parser, namespace=namespace, use_argv=use_argv
    )

    parser = setup_parser(parser)
    drawer_class(settings_core.drawer).add_settings(parser)
    if settings_core.filters is not None:
        for f in [f.strip() for f in settings_core.filters.split(",")]:
            filter_class(f.split(":")[0]).add_settings(parser)
    if settings_core.custom_loss is not None:
        for loss in [s.strip() for s in settings_core.custom_loss.split(",")]:
            loss_class(parse_prompt(loss.split("->")[0])[0]).add_settings(parser)

    if settings_dict:
        dests = [d.dest for d in parser._actions]
        for k in settings_dict:
            if k not in dests and k != "skip_args":
                raise ValueError(f"Requested setting not found, aborting: {k}={settings_dict[k]}")

    settings = process_args(
        parser, namespace, apply_side_effects=apply_side_effects, use_argv=use_argv
    )
    logging.debug(json.dumps(settings, default=lambda o: getattr(o, "__dict__", str(o)), sort_keys=True, indent=4))
    return settings
