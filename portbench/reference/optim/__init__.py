"""One module an optimizer, named as the traffic file's ``optimizer.name``
names the program's: ``init(bucket)`` its state of one bucket (a dict of
tensors like the bucket), ``update(p32, g32, state, lr=, args=)`` one
replica row's step in float32, returning the new weights and state;
``HELD`` the state that holds the first gradient after one step and
``first_gradient(x, args)`` that gradient from it."""
