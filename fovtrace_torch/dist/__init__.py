"""Row-sharded frames and the inverse-rendering train step on
torch.distributed (counterpart of `fovtrace/dist/`)."""
