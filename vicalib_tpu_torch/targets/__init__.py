from .grid import TargetGrid, load_preset, make_pattern, make_target  # noqa: F401
from .pattern_export import save_eps, save_svg  # noqa: F401
