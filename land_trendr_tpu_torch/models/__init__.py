"""models subpackage: the scalar NumPy/SciPy oracle (``pixel --engine oracle``)."""
