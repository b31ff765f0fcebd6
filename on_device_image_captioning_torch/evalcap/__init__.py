"""Caption metrics the training path needs: CIDEr-D for the SCST rewards
(counterpart of the JAX package's `evalcap/`; the rest of its metrics come
with the evaluation entry point)."""
