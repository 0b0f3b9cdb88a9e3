"""The benchmark's plain references, one module for each kind of model.

A configuration file names its module with `"reference": "<name>"`
(`reference/<name>.py`); without the key it is `model`, the epipolar
PoseResNet with the late `z` + BN + residual fusion.  The harness reaches a
reference only through `spec.Cell.reference`, so a new model brings its
reference as a new module and a configuration file that names it.

A reference module provides:

- `state_shapes(recipe) -> {name: shape}`: every parameter and buffer, in
  the order of the module's `state_dict`, under the names that the port's
  `ModelBuilder.reference` loads (the seed's weights are drawn in this order);
- `build(recipe, precision, state, device) -> nn.Module`: the model on
  `device` holding `state`, computing its convolutions in `precision`
  ("float32", "bfloat16" or "float8", as `model.round_to` rounds), called as
  `model(img, other_img, locs)` on (N, 3, H, W) images and (N, K, h, w, 2)
  sample locations (`geometry.sample_locations`) and returning heatmaps
  (N, J, h, w); `.train()` takes the batch's moments, `.eval()` the running
  ones;
- `loss(heatmaps, batch) -> scalar tensor`: the training loss of a batch as
  `harness/inputs.py` makes it ("heatmap", "visibility", ...);
- `forward_flops(recipe) -> int`: one item's forward (two views), as
  `FlopCounterMode` counts it, for the `mfu` metrics;
- `attention_bound(locs, recipe, dtype, backward) -> {"seconds", "flops",
  "bytes", "bound_by"}`: the least time of one attention call of this model
  at these locations, its features handed over in `dtype`, for the
  attention's roofline metrics (the peaks and `live_pairs` are
  `harness/work.py`'s);
- optionally `weight_rules`: keyword arguments of `harness.weights.make_state`
  (`no_relu_after`, `scaled_branch_bn`: name suffixes) where the module's
  layers need other rules than the defaults there.

Every module shares `model.Adam` and `geometry`.  A module may build on
`model`'s pieces (`Conv`, `BN`, the blocks, `PoseResNet` with a fusion of
its own, `round_to`, `SAMPLE_ELEMENTS`) and on the harness's `spec.sizes`
and `work`; it imports nothing of the program under test.
"""
