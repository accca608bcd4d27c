"""Training: the step, optimizer, loop, checkpoints and serving artifacts,
on one device or a device mesh."""
