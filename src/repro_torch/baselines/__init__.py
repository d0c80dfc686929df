"""Host baselines the accelerated path is compared against (counterpart of ``repro.baselines``)."""
