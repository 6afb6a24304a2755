"""Device operations of the forward step: variant apply, translation,
edit distance, and the step itself."""
