"""Tensor parallelism across rank processes (port of ``dynamo_tpu/parallel``):
``mesh.py`` the shard rules, ``comm.py`` the collectives."""
