// Native circuit scheduler for rs_tfhe_tpu.
//
// The device executes homomorphic gates fastest as large same-type batches
// (one fused blind-rotation kernel call per gate type); a boolean circuit
// arrives as a netlist of dependent gates. This scheduler turns a netlist
// into a batched execution plan on the host — the "runtime around the
// compute" role the reference delegates to its rayon Railgun loops
// (rs-tfhe examples/add_two_numbers.rs evaluates its 80-gate adder one
// bootstrap at a time):
//
//   1. levelize: Kahn topological pass over the wire-dependency DAG;
//      level(g) = 1 + max(level of g's input producers).
//   2. plan: gates stable-sorted by (level, op) into contiguous groups;
//      each group executes as ONE batched gate call on the device.
//
// Pure host-side integer work, C ABI for ctypes (rs_tfhe_tpu/models/
// netlist.py holds the Python fallback; tests assert parity).

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// Gate op codes (must match models/netlist.py):
//   0..9: two-input gates, 10: NOT (in_a only), 11: MUX (in_a=sel, b, c),
//   12: COPY (in_a only).
// Wires: [0, n_inputs) are circuit inputs; each gate writes out_wire
// exactly once (single static assignment). Returns the number of levels,
// or -1 on invalid input (wire out of range, double write, or a gate
// reading a wire nothing writes), or -2 on a dependency cycle.
int32_t circuit_levelize(const int32_t* op, const int32_t* in_a,
                         const int32_t* in_b, const int32_t* in_c,
                         const int32_t* out_wire, int32_t n_gates,
                         int32_t n_wires, int32_t n_inputs,
                         int32_t* level_out) {
  std::vector<int32_t> producer(n_wires, -1);  // gate writing each wire
  for (int32_t g = 0; g < n_gates; ++g) {
    int32_t w = out_wire[g];
    if (w < n_inputs || w >= n_wires || producer[w] != -1) return -1;
    producer[w] = g;
  }

  auto inputs_of = [&](int32_t g, int32_t* buf) -> int32_t {
    int32_t n = 0;
    buf[n++] = in_a[g];
    if (op[g] <= 9 || op[g] == 11) buf[n++] = in_b[g];
    if (op[g] == 11) buf[n++] = in_c[g];
    return n;
  };

  // indegree = number of gate-produced inputs not yet levelled
  std::vector<int32_t> indeg(n_gates, 0);
  std::vector<std::vector<int32_t>> consumers(n_wires);
  int32_t buf[3];
  for (int32_t g = 0; g < n_gates; ++g) {
    int32_t n = inputs_of(g, buf);
    for (int32_t i = 0; i < n; ++i) {
      int32_t w = buf[i];
      if (w < 0 || w >= n_wires) return -1;
      if (w >= n_inputs) {
        if (producer[w] == -1) return -1;  // reads a never-written wire
        indeg[g]++;
        consumers[w].push_back(g);
      }
    }
  }

  std::vector<int32_t> ready;
  for (int32_t g = 0; g < n_gates; ++g)
    if (indeg[g] == 0) {
      ready.push_back(g);
      level_out[g] = 0;
    }

  int32_t done = 0, max_level = -1;
  while (!ready.empty()) {
    std::vector<int32_t> next;
    for (int32_t g : ready) {
      ++done;
      if (level_out[g] > max_level) max_level = level_out[g];
      for (int32_t cg : consumers[out_wire[g]]) {
        if (level_out[cg] < level_out[g] + 1) level_out[cg] = level_out[g] + 1;
        if (--indeg[cg] == 0) next.push_back(cg);
      }
    }
    ready.swap(next);
  }
  if (done != n_gates) return -2;  // cycle
  return max_level + 1;
}

// Stable-sort gate indices by (level, op) and emit group boundaries.
// order_out: [n_gates]; group_start/group_op/group_level: [max_groups].
// Returns the number of groups, or -3 if max_groups is too small (callers
// size it as n_levels * 13), or the circuit_levelize error code.
int32_t circuit_plan(const int32_t* op, const int32_t* in_a,
                     const int32_t* in_b, const int32_t* in_c,
                     const int32_t* out_wire, int32_t n_gates,
                     int32_t n_wires, int32_t n_inputs,
                     int32_t* level_out, int32_t* order_out,
                     int32_t* group_start, int32_t* group_op,
                     int32_t* group_level, int32_t max_groups) {
  int32_t n_levels = circuit_levelize(op, in_a, in_b, in_c, out_wire,
                                      n_gates, n_wires, n_inputs, level_out);
  if (n_levels < 0) return n_levels;

  std::vector<int32_t> order(n_gates);
  for (int32_t g = 0; g < n_gates; ++g) order[g] = g;
  std::stable_sort(order.begin(), order.end(), [&](int32_t x, int32_t y) {
    if (level_out[x] != level_out[y]) return level_out[x] < level_out[y];
    return op[x] < op[y];
  });

  int32_t n_groups = 0;
  for (int32_t i = 0; i < n_gates; ++i) {
    int32_t g = order[i];
    order_out[i] = g;
    bool boundary = (i == 0) || level_out[g] != group_level[n_groups - 1] ||
                    op[g] != group_op[n_groups - 1];
    if (boundary) {
      if (n_groups == max_groups) return -3;
      group_start[n_groups] = i;
      group_op[n_groups] = op[g];
      group_level[n_groups] = level_out[g];
      ++n_groups;
    }
  }
  return n_groups;
}

}  // extern "C"
