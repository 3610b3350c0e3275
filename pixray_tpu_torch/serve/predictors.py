"""The Cog products of the port: streaming predictors over the engine.

Each product maps a small typed parameter schema onto settings, loads its
base YAML from ``COGS_DIR`` (the repository's ``cogs/``, or
``$PIXRAY_TPU_COGS``) and streams intermediate images: it runs the engine
with ``return_display=True`` and yields one frame per display, as
``pixray_tpu.serve.predictors`` does.  A product is built with the device
its engines run on (``"cuda"`` unless the caller says otherwise).

Every yielded frame is a file of its own in the temporary directory, which
the consumer removes once it is sent (the HTTP front end does): a frame
copied over one shared path could be overwritten by the next display
before it is read.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import tempfile
from typing import Iterator

from pixray_tpu_torch.utils import get_single_rgb

COGS_DIR = os.environ.get(
    "PIXRAY_TPU_COGS", os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "cogs")
)


def create_temporary_copy(src_path: str) -> str:
    """A copy of ``src_path`` under a new name in the temporary directory."""
    _, suffix = os.path.splitext(src_path)
    fd, temp_path = tempfile.mkstemp(prefix="pixray_frame_", suffix=suffix)
    os.close(fd)
    shutil.copy2(src_path, temp_path)
    return temp_path


def _yaml_dict(text: str) -> dict:
    import yaml

    return yaml.safe_load(text) or {}


class BasePixrayPredictor:
    """Streams partial results over the return_display contract."""

    def __init__(self, device="cuda"):
        self.device = device

    def setup(self):
        print("---> BasePixrayPredictor Setup")

    def predict(self, settings: str, **kwargs) -> Iterator[pathlib.Path]:
        import yaml

        import pixray_tpu_torch as pixray

        settings_file = os.path.join(COGS_DIR, f"{settings}.yaml")
        with open(settings_file, "r") as stream:
            base_settings = yaml.safe_load(stream)

        pixray.reset_settings()
        pixray.add_settings(**base_settings)
        pixray.add_settings(**kwargs)
        pixray.add_settings(skip_args=True)
        yield from self.stream(pixray.apply_settings())

    def stream(self, resolved) -> Iterator[pathlib.Path]:
        """Build the engine and yield a copy of the output image at every
        display and at the end.  The loop runs the engine ``do_init``
        returned, which a later ``do_init`` (the next job's, while this one
        is abandoned past its deadline) cannot swap under it."""
        import pixray_tpu_torch as pixray

        engine = pixray.do_init(resolved, device=self.device)
        run_complete = False
        while not run_complete:
            run_complete = engine.run(return_display=True)
            output_file = os.path.join(resolved.outdir, resolved.output)
            yield pathlib.Path(os.path.realpath(create_temporary_copy(output_file)))


class PixrayVqgan(BasePixrayPredictor):
    def predict(self, prompts: str = "rainbow mountain", quality: str = "normal",
                aspect: str = "widescreen", **kwargs) -> Iterator[pathlib.Path]:
        yield from super().predict(
            settings="pixray_vqgan", prompts=prompts, quality=quality, aspect=aspect, **kwargs
        )


class PixrayPixel(BasePixrayPredictor):
    def predict(self, prompts: str = "Beirut Skyline. #pixelart", aspect: str = "widescreen",
                drawer: str = "pixel", **kwargs) -> Iterator[pathlib.Path]:
        yield from super().predict(
            settings="pixray_pixel", prompts=prompts, aspect=aspect, drawer=drawer, **kwargs
        )


class Text2Image(BasePixrayPredictor):
    def predict(self, prompts: str = "Cairo skyline at sunset.", drawer: str = "vqgan",
                settings: str = "\n") -> Iterator[pathlib.Path]:
        yield from super().predict(settings="text2image", prompts=prompts, drawer=drawer, **_yaml_dict(settings))


class Text2Pixel(BasePixrayPredictor):
    def predict(self, prompts: str = "Manhattan skyline at sunset. #pixelart",
                aspect: str = "widescreen", pixel_scale: float = 1.0, **kwargs) -> Iterator[pathlib.Path]:
        yield from super().predict(
            settings="text2pixel", prompts=prompts, aspect=aspect, pixel_scale=pixel_scale, **kwargs
        )


class PixrayRaw(BasePixrayPredictor):
    def predict(self, prompts: str = "Manhattan skyline at sunset. #pixelart",
                settings: str = "\n") -> Iterator[pathlib.Path]:
        yield from super().predict(settings="pixrayraw", prompts=prompts, **_yaml_dict(settings))


class PixrayApi(BasePixrayPredictor):
    def predict(self, settings: str = "\n") -> Iterator[pathlib.Path]:
        yield from super().predict(settings="pixrayapi", **_yaml_dict(settings))


class Tiler(BasePixrayPredictor):
    def predict(self, prompts: str = "", pixelart: bool = False, mirror: bool = False,
                settings: str = "\n") -> Iterator[pathlib.Path]:
        ydict = _yaml_dict(settings)
        if pixelart:
            name = "tiler_pixel_shift" if mirror else "tiler_pixel"
            yield from super().predict(prompts=f"{prompts} #pixelart", settings=name, **ydict)
        else:
            name = "tiler_fft_shift" if mirror else "tiler_fft"
            yield from super().predict(prompts=prompts, settings=name, **ydict)


class PixrayVdiff(BasePixrayPredictor):
    def predict(self, prompts: str = "Manhattan skyline at sunset. #artstation 🌇",
                settings: str = "\n") -> Iterator[pathlib.Path]:
        yield from super().predict(settings="pixray_vdiff", prompts=prompts, **_yaml_dict(settings))


class EightBidG(BasePixrayPredictor):
    def predict(self, prompts: str = "", palette: str = "full color",
                border: str = "none") -> Iterator[pathlib.Path]:
        ydict: dict = {}
        if border == "none":
            ydict.update({"custom_loss": "smoothness:0.25"})
        else:
            ydict.update({
                "custom_loss": "edge,smoothness:0.25",
                "edge_thickness": 2,
                "edge_color": get_single_rgb(border),
            })
        if palette == "grayscale":
            ydict.update({"filters": "lookup", "palette": "black->white\\256"})
        elif palette == "web safe":
            ydict.update({"filters": "lookup", "palette": "https://www.pagetutor.com/common/net216pics/net216.gif"})
        yield from super().predict(prompts=prompts, settings="8bidg", **ydict)


class GenesisPredictor(BasePixrayPredictor):
    """The untitled-NFT genesis product: settings from the title and quality, no base YAML."""

    def predict(self, title: str = "", quality: str = "draft",
                optional_settings: str = "\n") -> Iterator[pathlib.Path]:
        import pixray_tpu_torch as pixray

        pixray.reset_settings()
        if quality == "draft":
            pixray.add_settings(output="genesis_draft.png", quality="draft", scale=2.5, iterations=100)
        else:
            pixray.add_settings(output="genesis.png", quality="best", scale=4, iterations=350)

        title = title.strip()
        if title in ("", "(untitled)"):
            title = "Wow, that looks amazing!|Trending on Artstation"
            pixray.add_settings(custom_loss="saturation")
        pixray.add_settings(prompts=title)

        optional_settings = optional_settings.strip()
        if optional_settings:
            import yaml

            ydict = yaml.safe_load(optional_settings)
            if ydict is not None:
                if ydict.get("drawer") == "pixel":
                    pixray.add_settings(prompts=f"{title} #pixelart")
                pixray.add_settings(**ydict)

        pixray.add_settings(skip_args=True)
        yield from self.stream(pixray.apply_settings())


PRODUCTS = {
    "text2image": Text2Image,
    "pixray_vqgan": PixrayVqgan,
    "pixray_pixel": PixrayPixel,
    "text2pixel": Text2Pixel,
    "pixrayraw": PixrayRaw,
    "pixrayapi": PixrayApi,
    "tiler": Tiler,
    "pixray_vdiff": PixrayVdiff,
    "8bidg": EightBidG,
    "genesis": GenesisPredictor,
}
