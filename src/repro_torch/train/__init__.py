"""The train step (microbatched gradients, AdamW) and the train loop with checkpoint/restart."""
