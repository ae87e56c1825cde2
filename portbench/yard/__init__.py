"""The benchmark's yardstick: traffic and world generation, the plain
reference of the decision, K1's operation and byte count, and the
comparison that decides `correct`.

Nothing here imports the program under test (`repro_torch`), the JAX
package or JAX: these files are frozen copies that later changes to the
program cannot move.
"""
