"""Distribution over ``torch.distributed`` (the JAX package's
``parallel``): a ("dp", "tp") mesh of ranks (``mesh``), the placement of a
batch's fields and a model's parameters on it (``sharding``), the ring
halo exchange and the sharded aggregation (``halo``), the sharded forward
and train step in both strategies (``train``) and the scaling sweep
(``scaling``).  Every rank runs one process; the caller initialises the
process group (NCCL for CUDA tensors, one rank per card; gloo for the
CPU, or for several ranks on one card with its buffers staged through
host memory).  Nothing here starts a process group by itself."""
