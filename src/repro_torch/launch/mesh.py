"""Device meshes over ``torch.distributed`` ranks (port of
``repro.launch.mesh``).

A mesh is one process per rank, laid out row-major over the reference's
axis names and order (``models.partitioning.Mesh``), with a process
group per axis.  ``torch.distributed`` is initialised by the caller (as
``launch.multihost.initialize`` does), and its world size must equal
the product of the mesh's axes.  The subgroups take the default group's
backend: NCCL with one card a rank, or gloo, which carries CUDA tensors
too, so several ranks can share one card.
"""

from __future__ import annotations

from repro_torch.models.partitioning import Mesh, build_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks per pod; 2x16x16 = 512 ranks multi-pod."""
    if multi_pod:
        return build_mesh(("pod", "data", "model"), (2, 16, 16))
    return build_mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1, worker: int = 1) -> Mesh:
    """A small mesh (tests, examples).  ``worker > 1`` prepends the
    serving "worker" axis (coded streams are worker-major over it,
    DESIGN.md §13); ``worker == 1`` keeps the 2-axis ("data", "model")
    mesh of the training paths."""
    if worker == 1:
        return build_mesh(("data", "model"), (data, model))
    return build_mesh(("worker", "data", "model"), (worker, data, model))


def make_train_mesh(data: int = 1, model: int = 1, *,
                    multi_pod: bool = False) -> Mesh:
    """The training mesh over the world: ("data", "model"), or with
    ``multi_pod`` ("pod", "data", "model") with a pod axis of 2, the
    production mesh's axes at any size.  The batch axes ("pod", "data")
    shard the batch's rows and, jointly, each weight's "fsdp"
    dimension; "model" splits heads, MLP and vocabulary."""
    if multi_pod:
        return build_mesh(("pod", "data", "model"), (2, data, model))
    return build_mesh(("data", "model"), (data, model))


def make_worker_mesh(workers: int, model: int = 1, *,
                     multi_pod: bool = False) -> Mesh:
    """Serving mesh: one rank per coded worker (x an optional model
    axis).  Each rank along "worker" owns a contiguous block of the N+1
    coded streams (worker-major layout), so a straggling or Byzantine
    worker is an actual process and the decode tail gathers only
    survivor shards; the ranks along "model" split its heads, MLP and
    vocabulary.  ``multi_pod`` prepends a "pod" axis of 2, as
    ``make_production_serving_mesh`` does: a worker's streams split over
    its two pod ranks (``partitioning.batch_block``)."""
    if multi_pod:
        return build_mesh(("pod", "worker", "model"), (2, workers, model))
    return build_mesh(("worker", "model"), (workers, model))


def make_production_serving_mesh(*, workers: int = 16, model: int = 16,
                                 multi_pod: bool = False) -> Mesh:
    """256-rank serving pod: 16 coded workers x 16-way tensor parallel.
    Multi-pod adds a leading "pod" axis (data-parallel pool replicas)."""
    if multi_pod:
        return build_mesh(("pod", "worker", "model"), (2, workers, model))
    return build_mesh(("worker", "model"), (workers, model))
