from . import se3, so3  # noqa: F401
