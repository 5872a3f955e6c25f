"""The slab step across a ring of processes (``torch.distributed``):
counterpart of ``gadget_leicester_tpu/parallel/`` (``mesh.py``,
``pm_sharded.py``, ``spmd.py``). ``launch.py`` starts the ranks."""
