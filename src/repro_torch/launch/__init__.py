# Launch layer (port of ``repro.launch``): the production mesh and the
# rule set for a mesh, the one-card rank layouts of the mesh router,
# ``specs`` (the AOT input specs of every step), ``serve`` (the LM's
# prefill, decode step and greedy loop), ``train`` (the train step and the
# training loop with checkpoint/restart) and ``dryrun`` (every arch x
# shape x mesh cell run once on fake tensors in a fake process group of
# its own). Like JAX's, it binds no name: import the modules.
