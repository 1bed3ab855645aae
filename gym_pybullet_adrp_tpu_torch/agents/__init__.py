"""The user controllers, on the port (the repo's agents/ imports the JAX
package): ``load_controller`` (utils/utils.py) finds them by name."""

from .base import BaseController

__all__ = ["BaseController"]
