"""LM model stack (counterpart of ``repro.models``): the GQA decode path that
serving runs."""
