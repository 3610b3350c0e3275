from .files import (
    brace_expand,
    emit_filename,
    get_file_path,
    map_number,
    parse_unit,
    real_glob,
    split_pipes,
    str2bool,
)
from .palette import get_single_rgb, palette_from_string

__all__ = [
    "brace_expand",
    "emit_filename",
    "get_single_rgb",
    "get_file_path",
    "map_number",
    "palette_from_string",
    "parse_unit",
    "real_glob",
    "split_pipes",
    "str2bool",
]
