"""The port's runtime support: checkpoint save and restore."""
