"""Parameter-tree helpers and the DRT layer partition."""
