"""Distributed training and retrieval across cards (the reference's
``distributed/`` package).

Like the port's other subpackages this ``__init__`` imports nothing (the
reference's re-exports form an import cycle through ``memory/``); import
the leaf modules:

* ``distributed.compression``: ``compressed_all_reduce`` (the reference's
  ``compressed_psum``), ``compression_ratio``, ``dequantize_int8``,
  ``init_error_feedback``, ``quantize_int8``;
* ``distributed.fault_tolerance``: ``ElasticRun``, ``HeartbeatMonitor``,
  ``StragglerPolicy``, ``elastic_slices``;
* ``distributed.sharding``: ``RULES_DEFAULT``, ``RULES_FSDP``,
  ``RULES_FSDP_LONG``, ``RULES_LONG_CONTEXT``, ``cache_shardings``,
  ``data_sharding``, ``param_shardings``, ``replicated``, ``spec_for``,
  ``tree_shardings``, and ``MeshAxes``, ``placements``, ``local_block``
  (specs onto a ``DeviceMesh``);
* ``distributed.tensor_parallel``: ``TPGroup``, ``MetaTPGroup``,
  ``shard_model``, ``shard_cache``, ``gather_cache``,
  ``check_tp_supported`` (the serve steps over a mesh's ``model`` axis).

The collectives' callers: ``training.train_loop.make_manual_dp_train_step``,
``core.hybrid_search.sharded_device_search`` and the serve steps of
``models.transformer`` given a ``tp`` group.
"""
