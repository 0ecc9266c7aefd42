from .models import (  # noqa: F401
    MAX_PARAMS, MODEL_ALIASES, MODELS, CameraModel, get_model, pad_params,
)
