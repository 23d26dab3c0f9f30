"""FIC: FIG parsing/building and the ensemble configuration model."""
