"""Launchers: ``serve.py`` (a serving engine over a synthetic corpus),
``dryrun.py`` (the sharded GUS cells at full size, measured, and the
architecture cells, sized on the meta device by ``cost.py`` and
``sharding.py``, run whole where one card holds them), ``train.py`` (the
LM training loop with checkpoint/restart) and ``mesh.py`` (where the
sharded index's shards go)."""
