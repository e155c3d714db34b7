"""Device ops: boundary max pooling (CUDA kernel + plain version), the
stem pack, the I3D's 3D max pool and soft-NMS.

Importing this package registers the kernels' `torch.library` custom ops
(`opental::boundary_max_pool_fwd`, `opental::boundary_max_pool_bwd`,
`opental::stem_pack96`, `opental::stem_pack96_v2`,
`opental::max_pool3d_same`), which a program saved by `tools/export.py`
names."""

from opental_torch.ops import (boundary_pool_cuda,  # noqa: F401
                               max_pool3d_cuda, stem_pack_cuda)
