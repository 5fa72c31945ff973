"""Hand-written Hopper kernels of the port, one subpackage each, and the
runtime surface (:mod:`.api`) that generated cuda twins call as
``__cuk``. Each kernel replaces a Pallas kernel of the reference package
and keeps a plain torch version beside it."""
