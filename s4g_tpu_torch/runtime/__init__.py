"""Host-side runtime: the training-data loaders and the device check."""
