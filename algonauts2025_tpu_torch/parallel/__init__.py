"""Data, tensor, sequence and pipeline parallelism (the port of
algonauts2025_tpu/parallel/)."""

from .mesh import LocalMesh, batch_sharding, get_mesh, init_distributed, local_mesh, replicated, shard_batch
from .pipeline import pipeline_scan, pipelined_llama_states
from .sequence import ring_attention_local, sequence_parallel_attention
