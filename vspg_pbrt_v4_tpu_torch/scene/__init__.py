from .parser import parse_pbrt_file, parse_pbrt_string  # noqa: F401
from .builder import build_render_setup  # noqa: F401
