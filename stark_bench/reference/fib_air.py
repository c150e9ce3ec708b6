"""fib_air (Plonky3's ``uni-stark/tests/fib_air.rs``): two columns (left,
right); the first row is (a, b), each next row is (right, left + right),
and the last row's right is x; the public values are [a, b, x]."""


class FibonacciAir:
    width = 2

    def eval(self, b) -> None:
        local, nxt = b.main_row(0), b.main_row(1)
        a, bv, x = b.public_value(0), b.public_value(1), b.public_value(2)
        first = b.when_first_row()
        first.assert_eq(local[0], a)
        first.assert_eq(local[1], bv)
        trans = b.when_transition()
        trans.assert_eq(nxt[0], local[1])
        trans.assert_eq(nxt[1], local[0] + local[1])
        b.when_last_row().assert_eq(local[1], x)
