from sdr_tpu_torch.parallel.mesh import make_link_mesh, mesh_info  # noqa: F401
from sdr_tpu_torch.parallel.shard import (  # noqa: F401
    make_sharded_coded_fn,
    make_sharded_coded_fast_fn,
    make_sharded_fast_fn,
    make_sharded_simulate_fn,
    make_sharded_stream_fn,
)
from sdr_tpu_torch.parallel.distributed import init_multihost  # noqa: F401
from sdr_tpu_torch.parallel.tp import make_tp_demod_fn  # noqa: F401
from sdr_tpu_torch.parallel.pp import make_pipelined_fast_fn  # noqa: F401
