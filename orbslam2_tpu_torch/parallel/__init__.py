"""Landmark-sharded bundle adjustment across shards of one process
(``sharded_ba``) and across processes, one per card (``distributed``,
``smoke_worker``)."""
