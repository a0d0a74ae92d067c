"""Data parallelism across processes, one per device.

Counterpart of ``personalized_text_to_speech_tpu/parallel/``: JAX lays a
``jax.sharding.Mesh`` over the devices of one program and lets GSPMD insert
the collectives; the port runs the reference's layout, one process per
device (``finetune_speaker_v2.py:50-69,144-145``), with explicit
``torch.distributed`` collectives in the train step (:mod:`.mesh`).
:mod:`.dryrun` is the counterpart of the data-parallel stage of
``__graft_entry__.py::dryrun_multichip``.  Tensor and sequence parallelism
(JAX ``parallel/tp.py``, ``parallel/sp.py``) are not ported yet (ROADMAP.md,
Queue 1, items 8 and 9).
"""

from personalized_text_to_speech_tpu_torch.parallel.mesh import (  # noqa: F401
    allreduce_,
    allreduce_grads,
    barrier,
    broadcast_module,
    create_mesh,
    is_primary,
    local_rank,
    rank,
    world_size,
)
