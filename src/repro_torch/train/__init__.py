"""Training on one card: the AdamW optimizer, integrity-checked
checkpoints, the train step and loop, crash-restart runs and
error-feedback gradient compression (``repro.train``'s modules, module
by module; the reference has no package exports here)."""
