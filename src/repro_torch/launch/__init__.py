"""Launch helpers: the data-parallel device mesh the CNN serving path
shards its batches over."""
from repro_torch.launch.mesh import DataMesh, make_data_mesh
