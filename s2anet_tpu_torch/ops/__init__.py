"""The port's ops. Importing the package registers the serving kernels as
custom ops (:mod:`.library`)."""

from . import library  # noqa: F401
