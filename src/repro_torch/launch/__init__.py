"""Launchers: ``serve.py`` (a serving engine over a synthetic corpus) and
``mesh.py`` (where the sharded index's shards go)."""
