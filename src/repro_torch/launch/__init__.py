# Launch layer (port of ``repro.launch``): the production mesh and the
# rule set for a mesh, the one-card rank layouts of the mesh router,
# ``serve`` (the LM's prefill, decode step and greedy loop) and ``train``
# (the train step and the training loop with checkpoint/restart). Like
# JAX's, it binds no name: import the modules. The AOT input specs and
# the dry run come with a later slice.
