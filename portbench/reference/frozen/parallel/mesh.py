"""One process: the reference never runs under a mesh."""
DataMesh = None


def all_reduce_sum_(mesh, tensors):
    raise RuntimeError("the reference runs in one process")


all_reduce_mean_ = all_reduce_sum_
