"""Training substrate: AdamW, gradient compression, checkpoints, the train
loop (counterpart of ``repro.train``)."""
