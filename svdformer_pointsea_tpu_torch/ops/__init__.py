"""Point-cloud ops. Each op with a kernel (FPS: K2, NN distance: K1) runs it
on CUDA tensors and its plain PyTorch version on CPU tensors; the EMD
auction, ball query and 3-NN are torch ops on both."""

from svdformer_pointsea_tpu_torch.ops.distances import (
    chamfer_distance,
    nn_launch_plan,
    nn_one_way,
    nn_one_way_plain,
    nn_squared_distance,
    query_knn,
    square_distance,
    three_interpolate,
    three_nn,
)
from svdformer_pointsea_tpu_torch.ops.emd import (
    earth_mover_distance,
    emd_convergence,
    emd_unassigned,
)
from svdformer_pointsea_tpu_torch.ops.fps import (
    fps_launch_plan,
    fps_subsample,
    furthest_point_sample,
    furthest_point_sample_ref,
    gather_points,
)
from svdformer_pointsea_tpu_torch.ops.grouping import (
    ball_query,
    group_local,
    grouping_operation,
    index_points,
    sample_and_group_all,
    sample_and_group_ball,
    sample_and_group_knn,
)
from svdformer_pointsea_tpu_torch.ops.metrics import density_aware_chamfer, fscore

__all__ = [
    "chamfer_distance",
    "nn_launch_plan",
    "nn_one_way",
    "nn_one_way_plain",
    "nn_squared_distance",
    "query_knn",
    "square_distance",
    "three_interpolate",
    "three_nn",
    "earth_mover_distance",
    "emd_convergence",
    "emd_unassigned",
    "fps_launch_plan",
    "fps_subsample",
    "furthest_point_sample",
    "furthest_point_sample_ref",
    "gather_points",
    "ball_query",
    "group_local",
    "grouping_operation",
    "index_points",
    "sample_and_group_all",
    "sample_and_group_ball",
    "sample_and_group_knn",
    "density_aware_chamfer",
    "fscore",
]
