"""Visualization (port of epipolar_transformers_tpu/vis): skeleton tables
and drawing, the eval frame dumps and their video, introspection dumps,
score curves and the notebook cursor.  matplotlib and ipyvolume are
imported only by the functions that draw with them."""

from .skeletons import (
    CONNECTIVITY_DICT,
    draw_2d_pose,
    draw_3d_pose,
    plot_hand_3d,
    plot_single_hand_2d,
    plot_two_hand_2d,
)
from .visualization import (
    assemble_video,
    auc_curve,
    epipolar_introspection,
    export_pointclouds,
)
