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

__all__ = [
    "brace_expand",
    "emit_filename",
    "get_file_path",
    "map_number",
    "parse_unit",
    "real_glob",
    "split_pipes",
    "str2bool",
]
