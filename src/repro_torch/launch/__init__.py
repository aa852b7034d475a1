"""Entry points of the port: the training loop and the dry run, with the meshes and cost accounting they use."""
