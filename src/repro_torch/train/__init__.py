"""Training on one card or data-parallel over a mesh of ranks: the
AdamW optimizer (ZeRO-2 moments), integrity-checked checkpoints, the
train step and loop, crash-restart runs and gradient compression
(``repro.train``'s modules, module by module; the reference has no
package exports here)."""
