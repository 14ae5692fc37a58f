"""The reference's optimizers, one module per optimizer, found by the
configuration's ``optimizer`` name: ``sample`` (the candidates from the
nominal knots and one iteration's standard normal noise) and ``update`` (the
new nominal knots from the candidates and their rewards)."""
