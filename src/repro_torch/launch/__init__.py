"""Launchers: ``serve.py`` (a serving engine over a synthetic corpus),
``dryrun.py`` (the sharded GUS cells at full size, measured) and
``mesh.py`` (where the sharded index's shards go)."""
