"""Reference motions for the tracking tasks."""
