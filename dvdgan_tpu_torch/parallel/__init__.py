"""Data and time parallelism over `torch.distributed` — the counterpart of
`dvdgan_tpu/parallel/`: `mesh` (process groups, the launch, the parallel
train step), `collectives` (the differentiable all-reduces and halos) and
`time_shard` (DT's context parallelism over the clip's time axis)."""
