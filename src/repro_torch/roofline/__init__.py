"""Copy of ``repro.roofline`` under ``repro_torch``.

Roofline cost vectors (``cost``): the pipeline plane's placement signal."""
