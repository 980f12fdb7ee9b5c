"""Host-side runtime: the training-data loaders."""
