"""The LM tower (port of ``repro/models``): ``layers.py``,
``transformer.py`` (dense, moe, vlm) with ``moe.py``, ``ssm.py`` and
``xlstm.py`` (ssm), ``encdec.py``, ``hybrid.py``, and ``model.py``'s
``build_model``."""
from repro_torch.models.model import build_model
