"""Launchers: ``serve.py`` (a serving engine over a synthetic corpus),
``dryrun.py`` (the sharded GUS cells at full size, measured),
``train.py`` (the LM training loop with checkpoint/restart) and
``mesh.py`` (where the sharded index's shards go)."""
