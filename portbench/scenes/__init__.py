"""Scene recipes, one module each, found by the name a configuration's
`scene.recipe` gives. Each has `make(n, params, generator)`, which returns
positions (n, 3) and features (n, 56), float32, on the generator's device,
drawn from it in a few large calls."""
