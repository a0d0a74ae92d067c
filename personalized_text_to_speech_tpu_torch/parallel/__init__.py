"""Data and tensor parallelism across processes, one per device.

Counterpart of ``personalized_text_to_speech_tpu/parallel/``: JAX lays a
``jax.sharding.Mesh`` over the devices of one program and lets GSPMD insert
the collectives; the port runs the reference's layout, one process per
device (``finetune_speaker_v2.py:50-69,144-145``), laid out as a ``[data,
model]`` array of ranks (:mod:`.mesh`; the world size is data × model),
with explicit ``torch.distributed`` collectives in the train step.
:mod:`.tp` shards the conv and embedding parameters over the ``model``
axis (JAX ``parallel/tp.py``).  :mod:`.dryrun` is the counterpart of the
data- and tensor-parallel stages of ``__graft_entry__.py::
dryrun_multichip``.  Sequence parallelism (JAX ``parallel/sp.py``) is not
ported yet (ROADMAP.md, Queue 1, item 9).
"""

from personalized_text_to_speech_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    allreduce_,
    allreduce_grads,
    barrier,
    broadcast_module,
    broadcast_over_data,
    create_mesh,
    is_primary,
    local_rank,
    mesh_shape,
    rank,
    world_size,
)
