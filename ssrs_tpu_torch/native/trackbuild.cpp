// Native track-reconstruction buffers for simulate_tracks_recorded.
//
// The device simulation emits per-chunk (chunk, B, 2) int16 position
// planes and (chunk, B) alive masks; trajectories are rebuilt host-side
// by appending each agent's alive-prefix of every chunk. In Python that
// is a per-agent loop per chunk (~1-2 s per 10k tracks); here it is a
// single C++ pass per chunk over contiguous buffers, with per-agent
// growable vectors and a one-shot flat export.
//
// A copy of ssrs_tpu/native/trackbuild.cpp for the PyTorch port
// (ssrs_tpu_torch/agents/simulate.py::simulate_tracks_recorded), which
// hands it each chunk's emissions from the card. Semantics: reference
// trajectory format, int16 (len, 2) arrays including the start cell
// (ssrs/movmodel.py:318). Alive is a prefix property within a chunk
// (agents never resurrect), so an agent's contribution from a chunk is
// its first sum(alive[:, j]) rows; the chunk length is the buffer's.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this toolchain).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct TrackBuilder {
    // per-agent flat (r0, c0, r1, c1, ...) int16 trajectories
    std::vector<std::vector<int16_t>> traj;
};

}  // namespace

extern "C" {

// Create a builder for n_agents, seeding each trajectory with its start
// cell from starts (n_agents, 2) int16.
void* tb_create(int64_t n_agents, const int16_t* starts) {
    auto* tb = new TrackBuilder();
    tb->traj.resize(static_cast<size_t>(n_agents));
    for (int64_t i = 0; i < n_agents; ++i) {
        tb->traj[i].reserve(64);
        tb->traj[i].push_back(starts[2 * i]);
        tb->traj[i].push_back(starts[2 * i + 1]);
    }
    return tb;
}

// Append one chunk: pos (chunk, b, 2) int16, alive (chunk, b) uint8,
// ids (b,) int32 mapping batch slots to agent indices (compaction
// reorders/truncates the batch between chunks).
void tb_append_chunk(void* handle, const int16_t* pos,
                     const uint8_t* alive, const int32_t* ids,
                     int64_t chunk, int64_t b) {
    auto* tb = static_cast<TrackBuilder*>(handle);
    for (int64_t j = 0; j < b; ++j) {
        int64_t cnt = 0;
        for (int64_t t = 0; t < chunk; ++t) {
            cnt += alive[t * b + j];
        }
        if (cnt == 0) continue;
        auto& v = tb->traj[static_cast<size_t>(ids[j])];
        v.reserve(v.size() + 2 * static_cast<size_t>(cnt));
        for (int64_t t = 0; t < cnt; ++t) {
            const int16_t* p = pos + (t * b + j) * 2;
            v.push_back(p[0]);
            v.push_back(p[1]);
        }
    }
}

// Total stored steps (rows) across all agents, starts included.
int64_t tb_total_rows(void* handle) {
    auto* tb = static_cast<TrackBuilder*>(handle);
    int64_t total = 0;
    for (const auto& v : tb->traj) total += static_cast<int64_t>(v.size() / 2);
    return total;
}

// Export: flat (total_rows, 2) int16 concatenation in agent order plus
// per-agent row counts (n_agents,) int64.
void tb_export(void* handle, int16_t* out_flat, int64_t* out_lens) {
    auto* tb = static_cast<TrackBuilder*>(handle);
    int64_t off = 0;
    for (size_t i = 0; i < tb->traj.size(); ++i) {
        const auto& v = tb->traj[i];
        out_lens[i] = static_cast<int64_t>(v.size() / 2);
        std::memcpy(out_flat + off, v.data(), v.size() * sizeof(int16_t));
        off += static_cast<int64_t>(v.size());
    }
}

void tb_destroy(void* handle) {
    delete static_cast<TrackBuilder*>(handle);
}

}  // extern "C"
