"""Scale-out over ``torch.distributed``: port of the JAX package's
``parallel/``.

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
``shard_map`` autodiff insert the collectives.  Here every rank runs the
same eager program (SPMD over processes) on a
``torch.distributed.device_mesh.DeviceMesh``, and the collectives that
autodiff gave JAX are written out as autograd functions in
:mod:`.collectives`:

* :mod:`.mesh`: process-group bring-up, the mesh, batch sharding and
  replication, and :func:`.mesh.spawn_ranks`, which starts the ranks of a
  one-host run;
* :mod:`.sharded_render`: tile-sharded rendering (each rank renders a
  horizontal slab of the image, the Gaussians replicated) and the 2-D
  data x tile batch render;
* :mod:`.gaussian_sharded`: Gaussian-sharded rendering and training (each
  rank owns 1/D of the scene and its Adam moments, densify and prune run
  shard-locally), alone and on a gauss x tile mesh;
* :mod:`.dryrun`: :func:`.dryrun.dryrun_multichip`, every layout's render,
  gradients and train steps on ``n`` ranks.
"""
