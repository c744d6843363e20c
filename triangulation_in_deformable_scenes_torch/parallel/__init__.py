"""Multi-rank execution on ``torch.distributed`` (counterpart of
``triangulation_in_deformable_scenes_tpu/parallel/``).

JAX runs one controller process over many devices (``Mesh``,
``NamedSharding``, ``shard_map``); here every rank is a process of its own
with one device, and what the partitioner did becomes rank-local code plus
explicit all-reduces:

- ``dist``: the rank layout (``Mesh``), pair-batch (serving) sharding and
  the landmark-sharded LM baseline, whose matvec exchanges the whole packed
  tangent;
- ``halo``: landmark sharding with the Morton partition and the halo PCG,
  which exchanges only the boundary rows;
- ``multihost``: process-group start-up from the ``TIDS_*`` variables and
  the (pairs, points) layout across hosts; ``multihost_worker`` is one rank
  of a smoke run;
- ``launch``: starts n ranks as subprocesses and collects their results.

A world of one process needs no process group: every collective over an
axis of one rank is skipped, as a ``psum`` over a trivial axis is the
identity.
"""
