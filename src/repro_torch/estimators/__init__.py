"""The estimator stack: sentence encoder, KNN quality/length index and
the per-tier GBM TPOT heads."""
