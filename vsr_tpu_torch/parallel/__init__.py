"""Multi-process training of the port (port of ``vsr_tpu/parallel``): the
process group (``distributed.py``), the mesh over the world's ranks
(``mesh.py``) and the ``data`` axis with ZeRO-1 and FSDP
(``data_parallel.py``). The ``spatial``, ``seq``, ``model``, ``pipe`` and
``expert`` axes are not ported yet and raise by name."""
