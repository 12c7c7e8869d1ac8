"""The LM tower (port of ``repro/models``): ``layers.py``,
``transformer.py`` (dense and vlm) and ``model.py``'s ``build_model``."""
from repro_torch.models.model import build_model
