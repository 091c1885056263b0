"""The two kinds of traffic the benchmark drives: ``train`` (``cli.train``'s
loop body) and ``render`` (``cli.render``'s loop).  A traffic file names
its kind; each kind module has ``run(cell) -> Result``."""
